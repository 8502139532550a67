"""The native map graph builds from source, into place, at first use."""

import ctypes
import os
import shutil

from orb_slam2_refactored_tpu import native


def test_rebuilds_a_deleted_library(tmp_path):
    src = os.path.join(os.path.dirname(native.__file__), os.pardir, "native")
    work = tmp_path / "native"
    work.mkdir()
    for f in ("Makefile", "map_graph.cpp"):
        shutil.copy(os.path.join(src, f), work / f)
    lib = native.build_library(str(work))
    assert os.path.exists(lib)
    os.remove(lib)
    lib = native.build_library(str(work))
    assert os.path.exists(lib)
    assert not os.path.exists(lib + ".tmp")
    handle = ctypes.CDLL(lib)
    handle.mg_create.restype = ctypes.c_void_p
    handle.mg_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    handle.mg_destroy.argtypes = [ctypes.c_void_p]
    g = handle.mg_create(4, 16)
    assert g
    handle.mg_destroy(g)
