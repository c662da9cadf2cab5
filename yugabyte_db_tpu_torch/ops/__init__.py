"""Device side of the port: plane upload and the aggregate folds.

- ``flat_agg``: the flat-run aggregate fold as a CUDA kernel
  (``csrc/flat_agg.cu``) with its plain PyTorch version;
- ``flat_fold``: the same fold in plain PyTorch for the signatures the
  kernel does not take (f64 predicates, float aggregates);
- ``mvcc_resolve`` / ``seg_fold``: a multi-version run resolved into a
  flat view (CUDA kernel ``csrc/mvcc_resolve.cu``) and its plain version;
- ``group_agg``: GROUP BY and expression aggregates, the bucket-table
  fold as a CUDA kernel (``csrc/group_agg.cu``) with its plain version;
- ``native``: builds and loads the CUDA kernels;
- ``device_run``: a run's planes resident on the engine's device, plain
  or as the encoded tree of ``encodings`` (the JAX package's compressed
  leaf forms), which ``decode`` (K10, ``csrc/decode.cu``) turns into the
  plain planes the other kernels read;
- ``scan`` / ``agg_fold``: the static signatures and the host-side
  packing/finalize shared with the JAX package's layout;
- ``mesh``: the mesh scans' cross-piece combine (K14's) and the stacked
  planes' slot update, CUDA kernels (``csrc/mesh.cu``) with their plain
  versions (``parallel`` drives them).
"""
