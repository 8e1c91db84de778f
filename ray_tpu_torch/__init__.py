"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's device path.

A package beside ``ray_tpu`` that imports ``torch`` (never ``jax``, and
nothing of ``ray_tpu``) and mirrors its layout: ``ops``, ``models``,
``llm``, ``parallel``, ``utils``. Every Pallas TPU kernel on a ported path
becomes a kernel written by hand for Hopper (``csrc/``, built by
``kernels``). Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
