"""The port's kernel build (``yugabyte_db_tpu_torch/ops/native.py``) keeps
``nvcc``'s output beside each library, so a process that finds every
library built still reads each kernel's ptxas report.

This host has no ``nvcc``: a stand-in compiler prints a ptxas line and
writes the library's file, and a second build must not call it.
"""

from __future__ import annotations

import stat

from yugabyte_db_tpu_torch.ops import native

PTXAS = "ptxas info    : Used 40 registers, 0 bytes spill stores"


def test_a_cached_library_keeps_its_ptxas_report(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        f"echo '{PTXAS}'\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(native, "build_logs", {})
    native.build(["flat_agg"])
    assert native.library_path("flat_agg").exists()
    assert native.log_path("flat_agg").name == \
        native.library_path("flat_agg").stem + ".log"
    assert PTXAS in native.build_logs["flat_agg"]
    # A later process: the library is cached, and its report is read back.
    monkeypatch.setattr(native, "build_logs", {})
    native.build(["flat_agg"])
    assert calls.read_text().count("x") == 1
    assert PTXAS in native.build_logs["flat_agg"]
