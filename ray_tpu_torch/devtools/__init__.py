"""Developer tooling for ray_tpu_torch: the chaos engine, process killers,
the churn harness and the linter.

``devtools.chaos`` (fault points, controller, plans, and the ``chaos``
subcommand of ``python -m ray_tpu_torch`` in ``chaos/cli.py``) is what the
runtime's fault points call; ``chaos/killers.py`` (seeded raylet and
worker killers over ``core.cluster.Cluster``) and ``churn.py`` (simulated
raylets joining and leaving a real GCS under placement-group load, with a
leak audit) are copied from ``ray_tpu/devtools`` too. ``lint`` is
raylint, the static analyzer, and the ``lint`` subcommand: JAX's rules
over the port's API, with RT017, the host-sync effect and the flow pass's
device regions designed for torch (it imports neither torch nor jax).
"""
