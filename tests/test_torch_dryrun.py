"""``ray_tpu_torch.entry.dryrun_multichip(8)`` on the CPU: 8 gloo ranks of a
TorchTrainer run one AdamW step of each parallelism configuration of
``__graft_entry__.dryrun_multichip`` (A-D), then the 2-worker trainer arm
and the sharded object plane's arm.

It runs in a fresh interpreter (the trainer's workers are its children)
under a 120 s clock, and every line JAX's dryrun prints must be there."""

import os
import re
import subprocess
import sys

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 41.7 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=240)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_dryrun():
    code = "from ray_tpu_torch.entry import dryrun_multichip; dryrun_multichip(8, device='cpu')"
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for label, mesh in [("dp·tp·sp", {"dp": 2, "tp": 2, "sp": 2}),
                        ("dp·fsdp·ep(moe)", {"dp": 2, "fsdp": 2, "ep": 2}),
                        ("dp·pp gpipe", {"dp": 4, "pp": 2}),
                        ("dp·tp·pp megatron-gpipe", {"dp": 2, "tp": 2, "pp": 2}),
                        ("torchtrainer 2-worker dp·tp", {"tp": 2})]:
        line = [ln for ln in lines if ln.startswith(f"dryrun[{label}] OK: ")]
        assert len(line) == 1, (label, lines)
        for axis, size in mesh.items():
            assert f"'{axis}': {size}" in line[0], (label, line[0])
        assert re.search(r"loss=\d+\.\d{4}$", line[0]), line[0]
    sharded = [ln for ln in lines if ln.startswith("dryrun[sharded-object-plane] OK: ")]
    assert len(sharded) == 1 and "shards=4 " in sharded[0], lines
    assert lines[-1] == "dryrun_multichip OK: devices=8, all configs finite"
