"""PyTorch/CUDA port of the yugabyte_db_tpu data plane.

A second package beside the JAX one, held against it by the
``tests/test_torch_*.py`` differential tests. It imports torch and numpy
only: the pure-Python modules it shares with the JAX package
(``models``, ``utils/planes.py``, the host storage structures) are its own
copies, so nothing here pulls in JAX.

This slice serves flat-run aggregate range scans through the ``gpu``
storage engine (``storage/gpu_engine.py``); the aggregate fold runs as a
hand-written CUDA kernel (``csrc/flat_agg.cu``, bound in
``ops/flat_agg.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
