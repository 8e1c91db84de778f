"""Device regions the port marks in torch's own ways, each with a host
sync one call hop below it, and the designed shapes that stay clean."""
import torch
from torch.autograd import Function

_LIB = torch.library.Library("fixture", "FRAGMENT")


def _scale_to_host(g):
    s = torch.mul(g, 2)
    return s.cpu()  # expect: RT022


class _ScaleGrad(Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        _scale_to_host(g)
        return g * 2


def _fence():
    torch.cuda.synchronize()  # expect: RT022


def _kernel_cuda(x):
    _fence()
    return x + 1


_LIB.define("bump(Tensor x) -> Tensor")
_LIB.impl("bump", _kernel_cuda, "CUDA")


def _norm_to_host(x):
    n = torch.linalg.norm(x)
    return n.item()  # expect: RT022


@torch.no_grad
def evaluate(x):
    return _norm_to_host(x)


def _count_to_host(x):
    c = torch.count_nonzero(x)
    return int(c)  # expect: RT022


def _graphed_step(x):
    _count_to_host(x)
    return x * 3


def _captured_step(x):
    return bool(torch.any(x))  # expect: RT022


def build(x):
    step = torch.cuda.make_graphed_callables(_graphed_step, (x,))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _captured_step(x)
    return step, graph


def read_after_region(x):
    # the designed shape: the region returns device values and the host
    # reads them once, outside it — clean
    y = _decode(x)
    return y.tolist()


@torch.inference_mode()
def _decode(x):
    return x + 1
