"""Host-device sync two hops below an inference_mode program (RT017's
class across helper calls).

A helper called from the decode program read a CUDA value back with
float(), making the host wait for the card once per step where the
decode block's budget is one wait per block. The flow pass must color
the inference_mode function as a device region and follow the hops:
_decode_step -> _track_loss -> _loss_to_host -> float(loss).
"""
import torch


def _loss_to_host(logits):
    loss = torch.mean(logits)
    return float(loss)  # expect: RT022


def _track_loss(logits):
    return _loss_to_host(logits)


@torch.inference_mode()
def _decode_step(carry, tok):
    logits = carry + tok
    _track_loss(logits)
    return logits, tok


def decode(carry, tokens):
    for tok in tokens:
        carry, _ = _decode_step(carry, tok)
    return carry
