"""RT017 fixture (torch): host-device sync inside a request-path loop body."""
import numpy as np
import torch
from torch.cuda import synchronize


def decode_step(tok):
    return torch.as_tensor(tok, device="cuda") + 1


def per_step_item(tokens):
    # the anti-pattern: one host wait per decode iteration
    out = []
    for t in tokens:
        r = torch.argmax(decode_step(t))
        out.append(r.item())  # expect: RT017
    return out


def per_step_tolist(tokens):
    out = []
    for t in tokens:
        r = torch.topk(decode_step(t), 2).indices
        out.extend(r.tolist())  # expect: RT017
    return out


def per_step_cpu(tokens):
    out = []
    for t in tokens:
        r = torch.mul(decode_step(t), 2)
        out.append(r.cpu())  # expect: RT017
    return out


def per_step_numpy(tokens):
    out = []
    for t in tokens:
        r = torch.mul(decode_step(t), 2)
        out.append(r.numpy(force=True))  # expect: RT017
    return out


def per_step_to_cpu(tokens):
    out = []
    for t in tokens:
        r = torch.mul(decode_step(t), 2)
        out.append(r.to("cpu"))  # expect: RT017
        out.append(r.to(device="cpu"))  # expect: RT017
    return out


def per_step_scalar_pull(tokens):
    total = 0.0
    while tokens:
        logit = torch.as_tensor(tokens.pop(), device="cuda")
        total += float(logit)  # expect: RT017
    return total


def int_and_bool_pull(tokens):
    out = []
    for t in tokens:
        nxt = torch.argmax(decode_step(t))
        out.append(int(nxt))  # expect: RT017
        if bool(nxt == 0):  # expect: RT017
            break
    return out


def numpy_materialize(tokens):
    out = []
    for t in tokens:
        r = torch.mul(decode_step(t), 2)
        out.append(np.asarray(r))  # expect: RT017
        out.append(np.array(r))  # expect: RT017
    return out


def tensor_method_binds(tokens):
    x = torch.arange(8, device="cuda")
    out = []
    for t in tokens:
        y = x.sum()  # a tensor method on a bound name is a device value
        z = y * t
        out.append(float(z))  # expect: RT017
    return out


def loop_over_device_rows():
    x = torch.randn(4, 8, device="cuda")
    out = []
    for row in x:  # the rows of a device tensor are device tensors
        out.append(float(row.max()))  # expect: RT017
    return out


def self_rebinding_sync(tokens):
    out = []
    for t in tokens:
        r = torch.mul(decode_step(t), 2)
        r = r.cpu()  # expect: RT017
        out.append(float(r))  # clean: r is a host tensor now
    return out


def comprehension_pull():
    x = torch.randn(4, device="cuda")
    return [v.item() for v in x]  # expect: RT017


def device_synchronize(tokens):
    for t in tokens:
        decode_step(t)
        torch.cuda.synchronize()  # expect: RT017
    for t in tokens:
        decode_step(t)
        synchronize()  # expect: RT017


def stream_and_event_synchronize(tokens):
    stream = torch.cuda.current_stream()
    for t in tokens:
        decode_step(t)
        stream.synchronize()  # expect: RT017
        done = torch.cuda.Event()
        done.record()
        done.synchronize()  # expect: RT017


def suppressed_env_step(env, tokens):
    for t in tokens:
        a = torch.argmax(decode_step(t))
        env.step(a.item())  # raylint: disable=RT017 -- the env steps on the host


def batched_sync_after_loop(tokens):
    # the designed shape: queue the whole block, ONE copy at the end
    blocks = []
    for t in tokens:
        blocks.append(decode_step(t))
    stacked = torch.stack(blocks)
    return stacked.cpu()  # copy once per block — clean


def sync_outside_loop(tokens):
    r = torch.as_tensor(tokens, device="cuda")
    torch.cuda.synchronize()  # no loop: a deliberate fence — clean
    return r.tolist()


def host_copy_read_in_loop(tokens):
    # one copy before the loop; the loop reads host memory
    h = torch.stack([decode_step(t) for t in tokens]).cpu()
    return [float(h[i]) for i in range(len(tokens))]  # clean: host tensor


def host_tensor_in_loop(rows):
    h = torch.ones(len(rows), device="cpu")  # a host tensor: no wait
    out = []
    for i in range(len(rows)):
        out.append(float(h[i]))  # clean: host tensor
    return out


def host_array_in_loop(rows):
    out = []
    for row in rows:
        arr = np.ones(4)
        out.append(np.asarray(arr))  # clean: host array
    return out


def rebound_name_is_clean(tokens):
    out = []
    for t in tokens:
        r = decode_step(t)
        r = [1, 2, 3]  # rebound to a host value before the pull
        out.append(np.asarray(r))  # clean: not a device tensor anymore
    return out


def metadata_is_clean(tokens):
    x = torch.zeros(4, 8, device="cuda")
    out = []
    for t in tokens:
        n = x.size(0)  # metadata: a host int, no wait
        out.append(int(n) + t)
    return out


def upload_in_loop_is_clean(rows):
    out = []
    for row in rows:
        out.append(torch.as_tensor(row).to("cuda"))  # host to card: not RT017's
    return out


def unknown_origin_is_clean(logits_list):
    # a parameter's origin is unknown: stay silent rather than guess
    return [float(x) for x in logits_list]


def deferred_bodies_are_clean(tokens):
    x = torch.arange(4, device="cuda")
    fns = []
    for t in tokens:
        fns.append(lambda: x.item())  # runs later, not per iteration

        def pull():
            return float(x)
        fns.append(pull)
    return fns
