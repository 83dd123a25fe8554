"""Probes of kernel B2 and of bit-plane expansion on the CUDA card, the
counterparts of the JAX package's TPU probes (``experiments/tpu_*.py``).

Each module has a ``main()`` (``python -m tpu3drecon_torch.experiments.<name>``
from the repo root, on a machine with the card) and a ``run()`` that
``chip_smoke.py`` calls with the problem it has built:

- ``index_matvec3`` (E2): B2 at ``terms`` 3, 2 and 1 and the PyTorch plane
  matvec on the BAL buckets: error against float64 rows, device time.
- ``term_stack`` (E3): B2 against its plain version at terms 3 and 1 on
  E3's random inputs: max|A - B| and device time.
- ``index_matvec2`` (E1): B2's launch shape on the BAL buckets (threads per
  block) and two timing-only variants without the camera-row gather or
  without the atomics (``csrc/probe_kernels.cu``).
- ``bits_expand`` (E4): a (100, 128) uint8 array unpacked into (100, 1024)
  float bit planes in two layouts, checked against numpy.

Nothing heavy is imported at module level: the modules import on a
machine without a card, and each ``run()`` raises there.
"""
