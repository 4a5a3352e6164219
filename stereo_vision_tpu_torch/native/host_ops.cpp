// Host-side preprocessing ops (C++, CPython C API).
//
// The port's copy of stereo_vision_tpu/native/host_ops.cpp, bit for bit the
// same arithmetic. The host ingestion loop — packing decoded RGB frames to
// grayscale and scanning brightness before anything reaches the card — runs
// multi-threaded with the GIL released, feeding the device staging of
// stereo_vision_tpu_torch.parallel.streaming.stream_video_pair.
//
//   pack_gray(frames_u8[T,H,W,3]) -> gray_u8[T,H,W]   (BT.601, x256 fixed point)
//   brightness_series(frames_u8[T,H,W] or [T,H,W,3]) -> float64[T]
//   png_unfilter(filtered, rows, stride, bpp) -> bytes   (PNG's five row filters)
//
// Build: stereo_vision_tpu_torch/native/build.py (g++ -O3 -fopenmp, cached .so).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// BT.601 luma in 8.8 fixed point: 77 R + 150 G + 29 B (sums to 256).
constexpr int kR = 77, kG = 150, kB = 29;

struct BufferGuard {
  Py_buffer view{};
  bool held = false;
  ~BufferGuard() {
    if (held) PyBuffer_Release(&view);
  }
};

bool GetContiguousU8(PyObject* obj, BufferGuard* g, int min_dims, int max_dims) {
  if (PyObject_GetBuffer(obj, &g->view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
    return false;
  }
  g->held = true;
  if (g->view.itemsize != 1) {
    PyErr_SetString(PyExc_TypeError, "expected uint8 array");
    return false;
  }
  if (g->view.ndim < min_dims || g->view.ndim > max_dims) {
    PyErr_SetString(PyExc_ValueError, "unexpected array rank");
    return false;
  }
  return true;
}

PyObject* PackGray(PyObject*, PyObject* args) {
  PyObject* frames;
  if (!PyArg_ParseTuple(args, "O", &frames)) return nullptr;
  BufferGuard g;
  if (!GetContiguousU8(frames, &g, 4, 4)) return nullptr;

  const Py_ssize_t T = g.view.shape[0], H = g.view.shape[1], W = g.view.shape[2];
  if (g.view.shape[3] != 3) {
    PyErr_SetString(PyExc_ValueError, "last axis must be RGB (3)");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, T * H * W);
  if (!out) return nullptr;
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  const uint8_t* src = reinterpret_cast<const uint8_t*>(g.view.buf);

  Py_BEGIN_ALLOW_THREADS
  const Py_ssize_t n = T * H * W;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (Py_ssize_t i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    dst[i] = static_cast<uint8_t>((kR * p[0] + kG * p[1] + kB * p[2] + 128) >> 8);
  }
  Py_END_ALLOW_THREADS
  return out;  // caller wraps via np.frombuffer().reshape(T, H, W)
}

PyObject* BrightnessSeries(PyObject*, PyObject* args) {
  PyObject* frames;
  if (!PyArg_ParseTuple(args, "O", &frames)) return nullptr;
  BufferGuard g;
  if (!GetContiguousU8(frames, &g, 3, 4)) return nullptr;

  const Py_ssize_t T = g.view.shape[0], H = g.view.shape[1], W = g.view.shape[2];
  const bool rgb = g.view.ndim == 4;
  if (rgb && g.view.shape[3] != 3) {
    PyErr_SetString(PyExc_ValueError, "last axis must be RGB (3)");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, T * (Py_ssize_t)sizeof(double));
  if (!out) return nullptr;
  double* dst = reinterpret_cast<double*>(PyBytes_AS_STRING(out));
  const uint8_t* src = reinterpret_cast<const uint8_t*>(g.view.buf);

  Py_BEGIN_ALLOW_THREADS
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (Py_ssize_t t = 0; t < T; ++t) {
    const Py_ssize_t px = H * W;
    uint64_t acc = 0;
    if (rgb) {
      const uint8_t* p = src + t * px * 3;
      for (Py_ssize_t i = 0; i < px; ++i) {
        acc += (uint64_t)((kR * p[0] + kG * p[1] + kB * p[2] + 128) >> 8);
        p += 3;
      }
    } else {
      const uint8_t* p = src + t * px;
      for (Py_ssize_t i = 0; i < px; ++i) acc += p[i];
    }
    dst[t] = static_cast<double>(acc) / static_cast<double>(px);
  }
  Py_END_ALLOW_THREADS
  return out;  // caller wraps via np.frombuffer(dtype=float64)
}

// A PNG image's inflated scanlines (each a filter-type byte and ``stride``
// bytes) back to its pixels: None, Sub, Up, Average and Paeth (PNG 1.2
// section 6), ``bpp`` bytes a pixel. Each row needs the previous one
// decoded, and Average and Paeth the pixel to their left: a sequential loop.
PyObject* PngUnfilter(PyObject*, PyObject* args) {
  PyObject* data;
  Py_ssize_t rows, stride, bpp;
  if (!PyArg_ParseTuple(args, "Onnn", &data, &rows, &stride, &bpp)) return nullptr;
  BufferGuard g;
  if (!GetContiguousU8(data, &g, 1, 1)) return nullptr;
  if (rows < 0 || stride < 0 || bpp < 1 || g.view.shape[0] < rows * (stride + 1)) {
    PyErr_SetString(PyExc_ValueError, "png_unfilter: the data is shorter than rows x (stride + 1)");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, rows * stride);
  if (!out) return nullptr;
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  const uint8_t* src = reinterpret_cast<const uint8_t*>(g.view.buf);
  int bad = -1;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t y = 0; y < rows && bad < 0; ++y) {
    const uint8_t* in = src + y * (stride + 1) + 1;
    const int type = src[y * (stride + 1)];
    uint8_t* row = dst + y * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    for (Py_ssize_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? row[i - bpp] : 0, b = up ? up[i] : 0, c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: pred = 0; bad = type;
      }
      row[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  Py_END_ALLOW_THREADS
  if (bad >= 0) {
    Py_DECREF(out);
    PyErr_Format(PyExc_ValueError, "png_unfilter: unknown filter type %d", bad);
    return nullptr;
  }
  return out;  // caller wraps via np.frombuffer().reshape(rows, stride)
}

PyMethodDef kMethods[] = {
    {"pack_gray", PackGray, METH_VARARGS,
     "pack_gray(frames_u8[T,H,W,3]) -> bytes of gray_u8[T,H,W]"},
    {"brightness_series", BrightnessSeries, METH_VARARGS,
     "brightness_series(frames_u8[T,H,W[,3]]) -> bytes of float64[T]"},
    {"png_unfilter", PngUnfilter, METH_VARARGS,
     "png_unfilter(filtered_u8, rows, stride, bpp) -> bytes of the unfiltered rows"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_host_ops",
    "Native host preprocessing for stereo_vision_tpu_torch", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__host_ops(void) { return PyModule_Create(&kModule); }
