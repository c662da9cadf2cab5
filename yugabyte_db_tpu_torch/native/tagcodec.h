// Shared tagged-binary codec core for the native extensions.
//
// Same wire grammar as yugabyte_db_tpu_torch/utils/codec.py (the canonical
// spec): tag byte then payload; varints are LEB128; ints are zigzag.
// Used by codec.cc (the yb_codec module). The port's copy of the JAX
// package's native/tagcodec.h; the native write plane that shares it
// there is not ported yet. Its namespace is its own (ybtag_torch): the
// function-local statics of these inline functions (the cached
// encode/decode_component_value) are GNU unique symbols, which the
// dynamic linker shares between every library loaded into a process,
// so under the JAX copy's name the JAX package's extension and this one
// would call each other's Python helpers.

#ifndef YB_TORCH_NATIVE_TAGCODEC_H
#define YB_TORCH_NATIVE_TAGCODEC_H

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace ybtag_torch {

enum Tag : unsigned char {
  T_NONE = 0, T_TRUE, T_FALSE, T_INT, T_F64, T_STR, T_BYTES, T_LIST,
  T_MAP,
  // Rich QL scalars (DECIMAL/VARINT-beyond-64-bit/UUID/TIMEUUID/INET/
  // DATE/TIME): varint length + the byte-comparable key-component
  // encoding (yugabyte_db_tpu_torch/models/encoding.py). Native code
  // skips them structurally;
  // decoding materializes through the Python helper (these ride the
  // host-payload path, never the native hot loops).
  T_EXT
};

constexpr int kMaxDepth = 200;

// -- growable output buffer --------------------------------------------------

struct Buf {
  char* data = nullptr;
  size_t len = 0, cap = 0;
  ~Buf() { PyMem_Free(data); }
};

inline bool buf_reserve(Buf* b, size_t extra) {
  if (b->len + extra <= b->cap) return true;
  size_t cap = b->cap ? b->cap : 256;
  while (cap < b->len + extra) cap *= 2;
  char* p = static_cast<char*>(PyMem_Realloc(b->data, cap));
  if (p == nullptr) { PyErr_NoMemory(); return false; }
  b->data = p;
  b->cap = cap;
  return true;
}

inline bool buf_put(Buf* b, const void* p, size_t n) {
  if (!buf_reserve(b, n)) return false;
  memcpy(b->data + b->len, p, n);
  b->len += n;
  return true;
}

inline bool buf_putc(Buf* b, unsigned char c) { return buf_put(b, &c, 1); }

inline bool write_varint(Buf* b, uint64_t v) {
  unsigned char tmp[10];
  int n = 0;
  for (;;) {
    unsigned char byte = v & 0x7F;
    v >>= 7;
    if (v) {
      tmp[n++] = byte | 0x80;
    } else {
      tmp[n++] = byte;
      return buf_put(b, tmp, n);
    }
  }
}

// -- encode ------------------------------------------------------------------

inline bool encode_obj(Buf* b, PyObject* v, int depth) {
  if (depth > kMaxDepth) {
    PyErr_SetString(PyExc_ValueError, "codec: nesting too deep");
    return false;
  }
  if (v == Py_None) return buf_putc(b, T_NONE);
  if (PyBool_Check(v)) return buf_putc(b, v == Py_True ? T_TRUE : T_FALSE);
  if (PyLong_Check(v)) {
    int overflow = 0;
    long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow != 0) {
      // > 64-bit int: the Python implementation handles it (wrapper
      // catches OverflowError and falls back).
      PyErr_SetString(PyExc_OverflowError, "int beyond int64");
      return false;
    }
    if (x == -1 && PyErr_Occurred()) return false;
    uint64_t z = (x >= 0)
        ? (static_cast<uint64_t>(x) << 1)
        : ((static_cast<uint64_t>(-(x + 1)) << 1) | 1);
    return buf_putc(b, T_INT) && write_varint(b, z);
  }
  if (PyFloat_Check(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    // wire format is little-endian f64; all supported targets are LE
    return buf_putc(b, T_F64) && buf_put(b, &d, 8);
  }
  if (PyUnicode_Check(v)) {
    PyObject* raw = PyUnicode_AsEncodedString(v, "utf-8", "surrogateescape");
    if (raw == nullptr) return false;
    char* p;
    Py_ssize_t n;
    if (PyBytes_AsStringAndSize(raw, &p, &n) < 0) {
      Py_DECREF(raw);
      return false;
    }
    bool ok = buf_putc(b, T_STR) && write_varint(b, (uint64_t)n) &&
              buf_put(b, p, (size_t)n);
    Py_DECREF(raw);
    return ok;
  }
  if (PyBytes_Check(v)) {
    char* p;
    Py_ssize_t n;
    if (PyBytes_AsStringAndSize(v, &p, &n) < 0) return false;
    return buf_putc(b, T_BYTES) && write_varint(b, (uint64_t)n) &&
           buf_put(b, p, (size_t)n);
  }
  if (PyByteArray_Check(v) || PyMemoryView_Check(v)) {
    PyObject* raw = PyBytes_FromObject(v);
    if (raw == nullptr) return false;
    bool ok = encode_obj(b, raw, depth);
    Py_DECREF(raw);
    return ok;
  }
  if (PyList_Check(v) || PyTuple_Check(v)) {
    PyObject* fast = PySequence_Fast(v, "codec: sequence");
    if (fast == nullptr) return false;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    bool ok = buf_putc(b, T_LIST) && write_varint(b, (uint64_t)n);
    for (Py_ssize_t i = 0; ok && i < n; i++) {
      ok = encode_obj(b, PySequence_Fast_GET_ITEM(fast, i), depth + 1);
    }
    Py_DECREF(fast);
    return ok;
  }
  if (PyDict_Check(v)) {
    if (!buf_putc(b, T_MAP) ||
        !write_varint(b, (uint64_t)PyDict_Size(v))) {
      return false;
    }
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
      if (!encode_obj(b, key, depth + 1) ||
          !encode_obj(b, val, depth + 1)) {
        return false;
      }
    }
    return true;
  }
  // Rich QL scalars (Decimal, UUID/TimeUuid, Inet, date, time): emit
  // T_EXT with the byte-comparable component encoding produced by the
  // Python helper (these never ride the native hot loops).
  {
    static PyObject* fn = nullptr;
    if (fn == nullptr) {
      PyObject* mod =
          PyImport_ImportModule("yugabyte_db_tpu_torch.models.encoding");
      if (mod != nullptr) {
        fn = PyObject_GetAttrString(mod, "encode_component_value");
        Py_DECREF(mod);
      }
      PyErr_Clear();
    }
    if (fn != nullptr) {
      PyObject* raw = PyObject_CallOneArg(fn, v);
      if (raw == nullptr) {
        PyErr_Clear();
      } else if (PyBytes_Check(raw)) {
        char* p;
        Py_ssize_t n;
        if (PyBytes_AsStringAndSize(raw, &p, &n) < 0) {
          Py_DECREF(raw);
          return false;
        }
        bool ok = buf_putc(b, T_EXT) && write_varint(b, (uint64_t)n) &&
                  buf_put(b, p, (size_t)n);
        Py_DECREF(raw);
        return ok;
      } else {
        Py_DECREF(raw);
      }
    }
  }
  PyErr_Format(PyExc_TypeError, "codec cannot encode %s",
               Py_TYPE(v)->tp_name);
  return false;
}

// -- decode ------------------------------------------------------------------

struct Reader {
  const unsigned char* data;
  size_t len, pos = 0;
};

inline bool read_varint(Reader* r, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  for (;;) {
    if (r->pos >= r->len) {
      PyErr_SetString(PyExc_ValueError, "codec: truncated varint");
      return false;
    }
    unsigned char byte = r->data[r->pos++];
    if (shift >= 64 || (shift == 63 && (byte & 0x7E))) {
      // arbitrary-precision int: fall back to the Python decoder
      PyErr_SetString(PyExc_OverflowError, "varint beyond uint64");
      return false;
    }
    result |= (uint64_t)(byte & 0x7F) << shift;
    if (!(byte & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
}

inline bool need(Reader* r, size_t n) {
  if (r->len - r->pos < n) {
    PyErr_SetString(PyExc_ValueError, "codec: truncated payload");
    return false;
  }
  return true;
}

inline PyObject* decode_obj(Reader* r, int depth) {
  if (depth > kMaxDepth) {
    PyErr_SetString(PyExc_ValueError, "codec: nesting too deep");
    return nullptr;
  }
  if (!need(r, 1)) return nullptr;
  unsigned char tag = r->data[r->pos++];
  switch (tag) {
    case T_NONE: Py_RETURN_NONE;
    case T_TRUE: Py_RETURN_TRUE;
    case T_FALSE: Py_RETURN_FALSE;
    case T_INT: {
      uint64_t z;
      if (!read_varint(r, &z)) return nullptr;
      long long x = (z & 1)
          ? -(long long)(z >> 1) - 1
          : (long long)(z >> 1);
      return PyLong_FromLongLong(x);
    }
    case T_F64: {
      if (!need(r, 8)) return nullptr;
      double d;
      memcpy(&d, r->data + r->pos, 8);
      r->pos += 8;
      return PyFloat_FromDouble(d);
    }
    case T_STR: {
      uint64_t n;
      if (!read_varint(r, &n) || !need(r, n)) return nullptr;
      PyObject* s = PyUnicode_DecodeUTF8(
          (const char*)(r->data + r->pos), (Py_ssize_t)n, "surrogateescape");
      r->pos += n;
      return s;
    }
    case T_BYTES: {
      uint64_t n;
      if (!read_varint(r, &n) || !need(r, n)) return nullptr;
      PyObject* s = PyBytes_FromStringAndSize(
          (const char*)(r->data + r->pos), (Py_ssize_t)n);
      r->pos += n;
      return s;
    }
    case T_LIST: {
      uint64_t n;
      if (!read_varint(r, &n)) return nullptr;
      if (n > r->len - r->pos) {  // each item needs >= 1 byte
        PyErr_SetString(PyExc_ValueError, "codec: bad list length");
        return nullptr;
      }
      PyObject* list = PyList_New((Py_ssize_t)n);
      if (list == nullptr) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject* item = decode_obj(r, depth + 1);
        if (item == nullptr) {
          Py_DECREF(list);
          return nullptr;
        }
        PyList_SET_ITEM(list, (Py_ssize_t)i, item);
      }
      return list;
    }
    case T_EXT: {
      uint64_t n;
      if (!read_varint(r, &n) || !need(r, n)) return nullptr;
      PyObject* raw = PyBytes_FromStringAndSize(
          (const char*)(r->data + r->pos), (Py_ssize_t)n);
      r->pos += n;
      if (raw == nullptr) return nullptr;
      static PyObject* fn = nullptr;
      if (fn == nullptr) {
        PyObject* mod =
            PyImport_ImportModule("yugabyte_db_tpu_torch.models.encoding");
        if (mod != nullptr) {
          fn = PyObject_GetAttrString(mod, "decode_component_value");
          Py_DECREF(mod);
        }
        if (fn == nullptr) {
          Py_DECREF(raw);
          return nullptr;
        }
      }
      PyObject* out = PyObject_CallOneArg(fn, raw);
      Py_DECREF(raw);
      return out;
    }
    case T_MAP: {
      uint64_t n;
      if (!read_varint(r, &n)) return nullptr;
      if (n > r->len - r->pos) {
        PyErr_SetString(PyExc_ValueError, "codec: bad map length");
        return nullptr;
      }
      PyObject* d = PyDict_New();
      if (d == nullptr) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject* key = decode_obj(r, depth + 1);
        if (key == nullptr) {
          Py_DECREF(d);
          return nullptr;
        }
        PyObject* val = decode_obj(r, depth + 1);
        if (val == nullptr) {
          Py_DECREF(key);
          Py_DECREF(d);
          return nullptr;
        }
        int rc = PyDict_SetItem(d, key, val);
        Py_DECREF(key);
        Py_DECREF(val);
        if (rc < 0) {
          Py_DECREF(d);
          return nullptr;
        }
      }
      return d;
    }
    default:
      PyErr_Format(PyExc_ValueError, "codec: bad tag 0x%02x at %zu",
                   tag, r->pos - 1);
      return nullptr;
  }
}

// Skip one encoded value without materializing it. Returns false (with a
// Python error set) on truncation/corruption.
inline bool skip_obj(Reader* r, int depth) {
  if (depth > kMaxDepth) {
    PyErr_SetString(PyExc_ValueError, "codec: nesting too deep");
    return false;
  }
  if (!need(r, 1)) return false;
  unsigned char tag = r->data[r->pos++];
  uint64_t n;
  switch (tag) {
    case T_NONE: case T_TRUE: case T_FALSE:
      return true;
    case T_INT:
      return read_varint(r, &n);
    case T_F64:
      if (!need(r, 8)) return false;
      r->pos += 8;
      return true;
    case T_STR: case T_BYTES: case T_EXT:
      if (!read_varint(r, &n) || !need(r, n)) return false;
      r->pos += n;
      return true;
    case T_LIST:
      if (!read_varint(r, &n)) return false;
      for (uint64_t i = 0; i < n; i++) {
        if (!skip_obj(r, depth + 1)) return false;
      }
      return true;
    case T_MAP:
      if (!read_varint(r, &n)) return false;
      for (uint64_t i = 0; i < 2 * n; i++) {
        if (!skip_obj(r, depth + 1)) return false;
      }
      return true;
    default:
      PyErr_Format(PyExc_ValueError, "codec: bad tag 0x%02x at %zu",
                   tag, r->pos - 1);
      return false;
  }
}

}  // namespace ybtag_torch

#endif  // YB_TORCH_NATIVE_TAGCODEC_H
