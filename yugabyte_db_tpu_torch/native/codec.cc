// Native implementation of the framework's tagged binary codec.
//
// Same wire grammar as yugabyte_db_tpu_torch/utils/codec.py (the canonical
// spec): tag byte then payload; varints are LEB128; ints are zigzag.
// The reference serializes its WAL/RPC records through C++ protobuf
// (src/yb/consensus/consensus.proto, log.proto) — this module puts the
// equivalent hot path (every RPC payload and WAL record body) in native
// code, with the Python implementation as the compatibility fallback
// for arbitrary-precision integers (OverflowError here -> Python path).
//
// The codec core lives in tagcodec.h. This is the port's copy of the
// JAX package's native/codec.cc; the loader in __init__.py builds it.
//
// Exposed as the CPython extension module `yb_codec`:
//   yb_codec.encode(obj) -> bytes
//   yb_codec.decode(bytes_like) -> obj

#include "tagcodec.h"

namespace {

using ybtag_torch::Buf;
using ybtag_torch::Reader;

PyObject* py_encode(PyObject*, PyObject* arg) {
  Buf b;
  if (!ybtag_torch::encode_obj(&b, arg, 0)) return nullptr;
  return PyBytes_FromStringAndSize(b.data, (Py_ssize_t)b.len);
}

PyObject* py_decode(PyObject*, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
  Reader r{static_cast<const unsigned char*>(view.buf),
           (size_t)view.len};
  PyObject* v = ybtag_torch::decode_obj(&r, 0);
  if (v != nullptr && r.pos != r.len) {
    PyErr_Format(PyExc_ValueError, "codec: %zu trailing bytes",
                 r.len - r.pos);
    Py_CLEAR(v);
  }
  PyBuffer_Release(&view);
  return v;
}

PyMethodDef kMethods[] = {
    {"encode", py_encode, METH_O, "encode(obj) -> bytes"},
    {"decode", py_decode, METH_O, "decode(bytes_like) -> obj"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "yb_codec",
    "native tagged binary codec (see yugabyte_db_tpu_torch/utils/codec.py)",
    -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit_yb_codec() { return PyModule_Create(&kModule); }
