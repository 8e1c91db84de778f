"""RT004 fixture (torch): large numpy/torch array passed inline to .remote()."""
import numpy as np
import torch
import ray_tpu_torch


@ray_tpu_torch.remote
def consume(arr):
    return arr.sum()


def bad_inline_literal():
    return consume.remote(torch.zeros((4096, 4096)))  # expect: RT004


def bad_inline_varargs():
    # torch.zeros(4096, 4096) is torch.zeros((4096, 4096))
    return consume.remote(torch.ones(512, 512))  # expect: RT004


def bad_inline_numpy():
    return consume.remote(np.zeros((4096, 4096)))  # expect: RT004


def bad_closure_capture():
    weights = torch.empty(1024, 1024, dtype=torch.float32)
    return consume.remote(weights)  # expect: RT004


def bad_kwarg():
    return consume.options(num_cpus=2).remote(arr=torch.full((300, 300), 7.0))  # expect: RT004


def bad_random():
    return consume.remote(torch.randn(256, 256, device="cpu"))  # expect: RT004


def bad_random_tuple():
    return consume.remote(torch.rand((256, 256)))  # expect: RT004


def bad_arange():
    return consume.remote(torch.arange(100_000))  # expect: RT004


def suppressed_single_consumer():
    # single consumer, single use: the spec copy is the cheapest path
    return consume.remote(torch.zeros(4096, 4096))  # raylint: disable=RT004


def good_small_tensor():
    return consume.remote(torch.zeros(8, 8))


def good_small_full():
    # full's second argument is the fill value, not a dimension
    return consume.remote(torch.full((8, 8), 100_000))


def good_put_ref():
    big = ray_tpu_torch.put(torch.zeros(4096, 4096))
    return consume.remote(big)


def good_rebound_small():
    # rebinding kills the large-array tracking for this name
    weights = torch.zeros(1024, 1024)
    weights = weights.sum()
    return consume.remote(weights)


def good_dynamic_shape(n):
    # size not statically known: stay silent rather than guess
    return consume.remote(torch.zeros(n, n))


def good_strided_arange():
    # 10_000 elements, not 100_000: start/end/step all count
    return consume.remote(torch.arange(0, 100_000, 10))


def good_offset_arange():
    return consume.remote(torch.arange(90_000, 100_000))


def good_tensor_from_data():
    # torch.tensor's argument is data, not a shape
    return consume.remote(torch.tensor(100_000))
