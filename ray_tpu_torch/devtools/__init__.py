"""Developer tooling for ray_tpu_torch: the chaos engine, process killers
and the churn harness.

``devtools.chaos`` (fault points, controller, plans, and the ``chaos``
subcommand of ``python -m ray_tpu_torch`` in ``chaos/cli.py``) is what the
runtime's fault points call; ``chaos/killers.py`` (seeded raylet and
worker killers over ``core.cluster.Cluster``) and ``churn.py`` (simulated
raylets joining and leaving a real GCS under placement-group load, with a
leak audit) are copied from ``ray_tpu/devtools`` too. The JAX package's
lint (raylint) and its ``lint`` subcommand are not ported yet.
"""
