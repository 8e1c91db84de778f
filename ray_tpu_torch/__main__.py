"""`python -m ray_tpu_torch <command>` — the CLI entry point."""
from ray_tpu_torch.scripts import main

main()
