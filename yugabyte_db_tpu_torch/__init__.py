"""PyTorch/CUDA port of the yugabyte_db_tpu data plane.

A second package beside the JAX one, held against it by the
``tests/test_torch_*.py`` differential tests. It imports torch and numpy
only: the pure-Python modules it shares with the JAX package
(``models``, ``utils/planes.py``, the host storage structures) are its own
copies, so nothing here pulls in JAX.

It serves aggregate range scans through the ``gpu`` storage engine
(``storage/gpu_engine.py``), over flat and multi-version runs and, after
writes, through the delta overlay, and GROUP BY and expression
aggregates (TPC-H Q1/Q6) over one run; the folds run as hand-written
CUDA kernels (``csrc/flat_agg.cu``, ``csrc/mvcc_resolve.cu`` and
``csrc/group_agg.cu``, bound in ``ops/flat_agg.py``,
``ops/mvcc_resolve.py`` and ``ops/group_agg.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
