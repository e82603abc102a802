// sage_icp_tpu native runtime: fast LiDAR scan IO + host preprocessing.
//
// The reference framework's runtime is C++ (ROS node + Eigen conversions,
// ros/ros2/Utils.hpp); in this framework the device owns all compute, and the
// host-side runtime work is scan loading + assembly of the fixed-shape
// device buffers. Doing that in C++ (with a GIL-releasing thread pool)
// keeps the host core feeding the device instead of burning it in
// numpy glue:
//   * load_scan: fread velodyne .bin (+ .label, id = raw & 0xFFFF,
//     reference eval/kitti_pub.py:153,176) into one (n, 4) float32 array
//   * HDL-64 scan correction: per-point 0.205 deg rotation about
//     axis = normalize(p x z) (reference eval/kitti_pub.py:55-84)
//   * pad_scan: copy into the fixed-capacity (cap, 4) buffer + valid mask
//     in one pass (the host-side half of the pipeline's fixed-shape ABI)
//
// Built as a CPython extension via setuptools (no pybind11 in this image).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr float kCorrectionRad = 0.205f * (float)M_PI / 180.0f;
constexpr float kInvalidCoord = 1.0e7f;

struct Scan {
  std::vector<float> data;  // n * 4 floats (x y z label)
  Py_ssize_t n = 0;
  bool ok = false;
  std::string error;
};

// Rotate p by kCorrectionRad about axis = normalize(p x z).
// Rodrigues: p' = c p + s (a x p) + (1 - c) a (a . p)
inline void correct_point(float &x, float &y, float &z) {
  // a = (p x z) / |p x z|; p x (0,0,1) = (y, -x, 0)
  float ax = y, ay = -x;
  float n = std::sqrt(ax * ax + ay * ay);
  if (n < 1e-12f) return;
  ax /= n;
  ay /= n;
  const float c = std::cos(kCorrectionRad);
  const float s = std::sin(kCorrectionRad);
  // a x p with az = 0: (ay*z, -ax*z, ax*y - ay*x)
  const float cx = ay * z;
  const float cy = -ax * z;
  const float cz = ax * y - ay * x;
  const float adotp = ax * x + ay * y;
  const float oc = 1.0f - c;
  const float nx = c * x + s * cx + oc * ax * adotp;
  const float ny = c * y + s * cy + oc * ay * adotp;
  const float nz = c * z + s * cz;
  x = nx;
  y = ny;
  z = nz;
}

Scan load_scan_impl(const char *velo_path, const char *label_path,
                    bool correct) {
  Scan out;
  FILE *f = std::fopen(velo_path, "rb");
  if (!f) {
    out.error = std::string("cannot open ") + velo_path;
    return out;
  }
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const Py_ssize_t n = bytes / (4 * sizeof(float));
  std::vector<float> raw(static_cast<size_t>(n) * 4);
  size_t got = std::fread(raw.data(), sizeof(float), raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) {
    out.error = std::string("short read on ") + velo_path;
    return out;
  }

  std::vector<int32_t> labels;
  if (label_path && label_path[0]) {
    FILE *lf = std::fopen(label_path, "rb");
    if (!lf) {
      out.error = std::string("cannot open ") + label_path;
      return out;
    }
    std::fseek(lf, 0, SEEK_END);
    long lbytes = std::ftell(lf);
    std::fseek(lf, 0, SEEK_SET);
    labels.resize(lbytes / sizeof(int32_t));
    size_t lg = std::fread(labels.data(), sizeof(int32_t), labels.size(), lf);
    std::fclose(lf);
    if (lg != labels.size()) {
      out.error = std::string("short read on ") + label_path;
      return out;
    }
  }

  out.data.resize(static_cast<size_t>(n) * 4);
  for (Py_ssize_t i = 0; i < n; ++i) {
    float x = raw[i * 4 + 0];
    float y = raw[i * 4 + 1];
    float z = raw[i * 4 + 2];
    if (correct) correct_point(x, y, z);
    out.data[i * 4 + 0] = x;
    out.data[i * 4 + 1] = y;
    out.data[i * 4 + 2] = z;
    // semantic id = raw & 0xFFFF (instance id lives in the high bits)
    const float lab =
        (static_cast<size_t>(i) < labels.size())
            ? static_cast<float>(labels[i] & 0xFFFF)
            : 0.0f;
    out.data[i * 4 + 3] = lab;
  }
  out.n = n;
  out.ok = true;
  return out;
}

PyObject *scan_to_array(Scan &scan) {
  npy_intp dims[2] = {scan.n, 4};
  PyObject *arr = PyArray_SimpleNew(2, dims, NPY_FLOAT32);
  if (!arr) return nullptr;
  std::memcpy(PyArray_DATA((PyArrayObject *)arr), scan.data.data(),
              scan.data.size() * sizeof(float));
  return arr;
}

PyObject *py_load_scan(PyObject *, PyObject *args, PyObject *kwargs) {
  const char *velo_path = nullptr;
  const char *label_path = nullptr;
  int correct = 1;
  static const char *kwlist[] = {"velo_path", "label_path", "correct",
                                 nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|zp",
                                   const_cast<char **>(kwlist), &velo_path,
                                   &label_path, &correct))
    return nullptr;

  Scan scan;
  Py_BEGIN_ALLOW_THREADS;
  scan = load_scan_impl(velo_path, label_path, correct != 0);
  Py_END_ALLOW_THREADS;
  if (!scan.ok) {
    PyErr_SetString(PyExc_IOError, scan.error.c_str());
    return nullptr;
  }
  return scan_to_array(scan);
}

// pad_scan(scan (n,4) f32, capacity) -> (buf (cap,4) f32, valid (cap,) bool)
PyObject *py_pad_scan(PyObject *, PyObject *args) {
  PyObject *obj = nullptr;
  Py_ssize_t cap = 0;
  if (!PyArg_ParseTuple(args, "On", &obj, &cap)) return nullptr;
  PyArrayObject *in = (PyArrayObject *)PyArray_FROM_OTF(
      obj, NPY_FLOAT32, NPY_ARRAY_IN_ARRAY);
  if (!in) return nullptr;
  if (PyArray_NDIM(in) != 2 || PyArray_DIM(in, 1) != 4) {
    Py_DECREF(in);
    PyErr_SetString(PyExc_ValueError, "scan must be (n, 4) float32");
    return nullptr;
  }
  const Py_ssize_t n = PyArray_DIM(in, 0) < cap ? PyArray_DIM(in, 0) : cap;

  npy_intp bdims[2] = {cap, 4};
  npy_intp vdims[1] = {cap};
  PyObject *buf = PyArray_SimpleNew(2, bdims, NPY_FLOAT32);
  PyObject *val = PyArray_SimpleNew(1, vdims, NPY_BOOL);
  if (!buf || !val) {
    Py_DECREF(in);
    Py_XDECREF(buf);
    Py_XDECREF(val);
    return nullptr;
  }
  float *bp = (float *)PyArray_DATA((PyArrayObject *)buf);
  npy_bool *vp = (npy_bool *)PyArray_DATA((PyArrayObject *)val);
  const float *sp = (const float *)PyArray_DATA(in);
  Py_BEGIN_ALLOW_THREADS;
  std::memcpy(bp, sp, static_cast<size_t>(n) * 4 * sizeof(float));
  for (Py_ssize_t i = n * 4; i < cap * 4; ++i) bp[i] = kInvalidCoord;
  std::memset(vp, 1, static_cast<size_t>(n));
  std::memset(vp + n, 0, static_cast<size_t>(cap - n));
  Py_END_ALLOW_THREADS;
  Py_DECREF(in);
  return PyTuple_Pack(2, buf, val);
}

PyMethodDef methods[] = {
    {"load_scan", (PyCFunction)py_load_scan, METH_VARARGS | METH_KEYWORDS,
     "load_scan(velo_path, label_path=None, correct=True) -> (n,4) float32 "
     "[x y z label]; label = raw & 0xFFFF; optional HDL-64 correction."},
    {"pad_scan", py_pad_scan, METH_VARARGS,
     "pad_scan(scan, capacity) -> (buf (cap,4) f32, valid (cap,) bool)"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "native scan IO + host preprocessing for sage_icp_tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
