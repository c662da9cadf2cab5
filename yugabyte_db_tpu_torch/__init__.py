"""PyTorch/CUDA port of the yugabyte_db_tpu data plane.

A second package beside the JAX one, held against it by the
``tests/test_torch_*.py`` differential tests. It imports torch and numpy
only: the pure-Python modules it shares with the JAX package
(``models``, ``utils/planes.py``, the host storage structures) are its own
copies, so nothing here pulls in JAX.

It serves aggregate range scans through the ``gpu`` storage engine
(``storage/gpu_engine.py``), over flat and multi-version runs and, after
writes, through the delta overlay; the folds run as hand-written CUDA
kernels (``csrc/flat_agg.cu`` and ``csrc/mvcc_resolve.cu``, bound in
``ops/flat_agg.py`` and ``ops/mvcc_resolve.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
