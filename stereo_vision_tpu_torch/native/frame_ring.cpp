// Native frame-ring runtime (C++, CPython C API).
//
// The port's copy of stereo_vision_tpu/native/frame_ring.cpp. A video is
// decoded one frame at a time, but the card works on windows of frames: the
// device runs one window while the host decodes and packs the NEXT one. This
// file is the host half of that pipeline — a fixed-capacity MPMC ring of
// frame-window slots with blocking put/get that release the GIL, plus a
// fused RGB->grayscale pack (OpenMP) that converts directly into the slot,
// so decoded frames cross Python exactly once.
//
//   ring_create(slots, slot_bytes) -> handle
//   ring_put_gray(handle, rgb_u8[T,H,W,3])   pack BT.601 gray into a slot
//   ring_put_raw(handle, u8[slot_bytes])     memcpy a pre-packed window
//   ring_get_into(handle, out_u8, timeout_ms) -> seq | -1 timeout | -2 drained
//   ring_close(handle)                       EOF: drain then get -> -2
//   ring_stats(handle) -> (occupied, slots, closed)
//   ring_waits(handle) -> (put_wait_ns, puts, get_wait_ns, gets) of the ring
//   ring_totals() -> the same summed over every ring since the module loaded,
//                    destroyed rings included
//   ring_destroy(handle)
//
// A put's or get's wait, for a free or a filled slot, is read on
// steady_clock from before the ring's mutex is taken (time spent taking it
// counts as waiting) to the condition variable's release. A call that finds
// the mutex free and its slot ready reads no clock.
//
// Sequence numbers are assigned at put time (0, 1, 2, ...) so a single
// producer's windows arrive strictly in decode order; metadata keyed by
// seq lives on the Python side (io/loader.py).
//
// Build: stereo_vision_tpu_torch/native/build.py (g++ -O3 -fopenmp, cached .so).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

// BT.601 luma in 8.8 fixed point: 77 R + 150 G + 29 B (sums to 256) —
// identical to host_ops.cpp pack_gray so the two paths are bit-equal.
constexpr int kR = 77, kG = 150, kB = 29;

struct Ring {
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::vector<uint8_t> storage;  // slots * slot_bytes
  std::vector<int64_t> seq;      // per-slot sequence number
  Py_ssize_t slots = 0;
  Py_ssize_t slot_bytes = 0;
  Py_ssize_t head = 0;  // next slot to fill
  Py_ssize_t tail = 0;  // next slot to drain
  Py_ssize_t count = 0;
  bool closed = false;
  int64_t next_seq = 0;
  int64_t put_wait_ns = 0, puts = 0, get_wait_ns = 0, gets = 0;  // under mu
};

// Every ring's waits and calls since the module loaded.
std::atomic<int64_t> g_put_wait_ns{0}, g_puts{0}, g_get_wait_ns{0}, g_gets{0};

// Takes `lock` (made with std::try_to_lock) and waits on `cv` until
// `ready()` or, with timeout_ms >= 0, the timeout; returns whether ready()
// held and adds the nanoseconds waited to *wait_ns. The clock is read only
// where the mutex was busy or the slot not ready.
template <typename Ready>
bool TimedWait(std::unique_lock<std::mutex>& lock, std::condition_variable& cv,
               long long timeout_ms, Ready ready, int64_t* wait_ns) {
  if (lock.owns_lock() && ready()) return true;
  const auto t0 = std::chrono::steady_clock::now();
  if (!lock.owns_lock()) lock.lock();
  bool ok = true;
  if (timeout_ms < 0) {
    cv.wait(lock, ready);
  } else {
    ok = cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), ready);
  }
  *wait_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                  std::chrono::steady_clock::now() - t0).count();
  return ok;
}

std::mutex g_registry_mu;
std::unordered_map<int64_t, std::shared_ptr<Ring>> g_rings;
int64_t g_next_handle = 1;

std::shared_ptr<Ring> LookupRing(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_registry_mu);
  auto it = g_rings.find(handle);
  return it == g_rings.end() ? nullptr : it->second;
}

struct BufferGuard {
  Py_buffer view{};
  bool held = false;
  ~BufferGuard() {
    if (held) PyBuffer_Release(&view);
  }
};

bool GetU8Buffer(PyObject* obj, BufferGuard* g, bool writable) {
  int flags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT;
  if (writable) flags |= PyBUF_WRITABLE;
  if (PyObject_GetBuffer(obj, &g->view, flags) != 0) return false;
  g->held = true;
  if (g->view.itemsize != 1) {
    PyErr_SetString(PyExc_TypeError, "expected uint8 array");
    return false;
  }
  return true;
}

PyObject* RingCreate(PyObject*, PyObject* args) {
  Py_ssize_t slots, slot_bytes;
  if (!PyArg_ParseTuple(args, "nn", &slots, &slot_bytes)) return nullptr;
  if (slots <= 0 || slot_bytes <= 0) {
    PyErr_SetString(PyExc_ValueError, "slots and slot_bytes must be positive");
    return nullptr;
  }
  auto ring = std::make_shared<Ring>();
  ring->slots = slots;
  ring->slot_bytes = slot_bytes;
  ring->storage.resize(static_cast<size_t>(slots) * slot_bytes);
  ring->seq.resize(slots, -1);
  int64_t handle;
  {
    std::lock_guard<std::mutex> lock(g_registry_mu);
    handle = g_next_handle++;
    g_rings[handle] = std::move(ring);
  }
  return PyLong_FromLongLong(handle);
}

// Shared put path: waits for a free slot (GIL released), then runs `fill`
// (gray pack or memcpy) into the slot. Returns seq, or -2 if the ring was
// closed (wrapper raises).
template <typename Fill>
int64_t PutCommon(Ring& ring, Fill fill) {
  int64_t out_seq = -2;
  {
    std::unique_lock<std::mutex> lock(ring.mu, std::try_to_lock);
    int64_t waited = 0;
    TimedWait(lock, ring.not_full, -1,
              [&] { return ring.count < ring.slots || ring.closed; }, &waited);
    ring.put_wait_ns += waited;
    ring.puts++;
    g_put_wait_ns.fetch_add(waited, std::memory_order_relaxed);
    g_puts.fetch_add(1, std::memory_order_relaxed);
    if (ring.closed) return -2;
    uint8_t* slot = ring.storage.data() +
                    static_cast<size_t>(ring.head) * ring.slot_bytes;
    // Fill outside the lock would allow a racing producer to claim the same
    // slot; single-producer rings dominate here and the pack is the actual
    // work, so hold the lock (consumers block on not_empty, not on mu long).
    fill(slot);
    out_seq = ring.next_seq++;
    ring.seq[ring.head] = out_seq;
    ring.head = (ring.head + 1) % ring.slots;
    ring.count++;
  }
  ring.not_empty.notify_one();
  return out_seq;
}

PyObject* RingPutGray(PyObject*, PyObject* args) {
  long long handle;
  PyObject* rgb;
  if (!PyArg_ParseTuple(args, "LO", &handle, &rgb)) return nullptr;
  auto ring = LookupRing(handle);
  if (!ring) {
    PyErr_SetString(PyExc_ValueError, "unknown ring handle");
    return nullptr;
  }
  BufferGuard g;
  if (!GetU8Buffer(rgb, &g, /*writable=*/false)) return nullptr;
  if (g.view.len % 3 != 0 || g.view.len / 3 != ring->slot_bytes) {
    PyErr_SetString(PyExc_ValueError,
                    "rgb buffer must hold slot_bytes * 3 bytes");
    return nullptr;
  }
  const uint8_t* src = reinterpret_cast<const uint8_t*>(g.view.buf);
  const Py_ssize_t n = ring->slot_bytes;

  int64_t seq;
  Py_BEGIN_ALLOW_THREADS
  seq = PutCommon(*ring, [&](uint8_t* slot) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (Py_ssize_t i = 0; i < n; ++i) {
      const uint8_t* p = src + i * 3;
      slot[i] = static_cast<uint8_t>((kR * p[0] + kG * p[1] + kB * p[2] + 128) >> 8);
    }
  });
  Py_END_ALLOW_THREADS
  if (seq == -2) {
    PyErr_SetString(PyExc_RuntimeError, "put on closed ring");
    return nullptr;
  }
  return PyLong_FromLongLong(seq);
}

PyObject* RingPutRaw(PyObject*, PyObject* args) {
  long long handle;
  PyObject* buf;
  if (!PyArg_ParseTuple(args, "LO", &handle, &buf)) return nullptr;
  auto ring = LookupRing(handle);
  if (!ring) {
    PyErr_SetString(PyExc_ValueError, "unknown ring handle");
    return nullptr;
  }
  BufferGuard g;
  if (!GetU8Buffer(buf, &g, /*writable=*/false)) return nullptr;
  if (g.view.len != ring->slot_bytes) {
    PyErr_SetString(PyExc_ValueError, "buffer must hold exactly slot_bytes");
    return nullptr;
  }
  const uint8_t* src = reinterpret_cast<const uint8_t*>(g.view.buf);
  const size_t n = static_cast<size_t>(ring->slot_bytes);

  int64_t seq;
  Py_BEGIN_ALLOW_THREADS
  seq = PutCommon(*ring, [&](uint8_t* slot) { std::memcpy(slot, src, n); });
  Py_END_ALLOW_THREADS
  if (seq == -2) {
    PyErr_SetString(PyExc_RuntimeError, "put on closed ring");
    return nullptr;
  }
  return PyLong_FromLongLong(seq);
}

PyObject* RingGetInto(PyObject*, PyObject* args) {
  long long handle, timeout_ms;
  PyObject* out;
  if (!PyArg_ParseTuple(args, "LOL", &handle, &out, &timeout_ms)) return nullptr;
  auto ring = LookupRing(handle);
  if (!ring) {
    PyErr_SetString(PyExc_ValueError, "unknown ring handle");
    return nullptr;
  }
  BufferGuard g;
  if (!GetU8Buffer(out, &g, /*writable=*/true)) return nullptr;
  if (g.view.len != ring->slot_bytes) {
    PyErr_SetString(PyExc_ValueError, "out buffer must hold exactly slot_bytes");
    return nullptr;
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(g.view.buf);

  int64_t seq = -1;
  Py_BEGIN_ALLOW_THREADS
  {
    std::unique_lock<std::mutex> lock(ring->mu, std::try_to_lock);
    int64_t waited = 0;
    bool ok = TimedWait(lock, ring->not_empty, timeout_ms,
                        [&] { return ring->count > 0 || ring->closed; }, &waited);
    ring->get_wait_ns += waited;
    ring->gets++;
    g_get_wait_ns.fetch_add(waited, std::memory_order_relaxed);
    g_gets.fetch_add(1, std::memory_order_relaxed);
    if (!ok || ring->count == 0) {
      seq = (ring->count == 0 && ring->closed) ? -2 : -1;
    } else {
      const uint8_t* slot = ring->storage.data() +
                            static_cast<size_t>(ring->tail) * ring->slot_bytes;
      std::memcpy(dst, slot, static_cast<size_t>(ring->slot_bytes));
      seq = ring->seq[ring->tail];
      ring->tail = (ring->tail + 1) % ring->slots;
      ring->count--;
    }
  }
  if (seq >= 0) ring->not_full.notify_one();
  Py_END_ALLOW_THREADS
  return PyLong_FromLongLong(seq);
}

PyObject* RingClose(PyObject*, PyObject* args) {
  long long handle;
  if (!PyArg_ParseTuple(args, "L", &handle)) return nullptr;
  auto ring = LookupRing(handle);
  if (!ring) {
    PyErr_SetString(PyExc_ValueError, "unknown ring handle");
    return nullptr;
  }
  {
    std::lock_guard<std::mutex> lock(ring->mu);
    ring->closed = true;
  }
  ring->not_empty.notify_all();
  ring->not_full.notify_all();
  Py_RETURN_NONE;
}

PyObject* RingStats(PyObject*, PyObject* args) {
  long long handle;
  if (!PyArg_ParseTuple(args, "L", &handle)) return nullptr;
  auto ring = LookupRing(handle);
  if (!ring) {
    PyErr_SetString(PyExc_ValueError, "unknown ring handle");
    return nullptr;
  }
  std::lock_guard<std::mutex> lock(ring->mu);
  return Py_BuildValue("(nni)", ring->count, ring->slots,
                       ring->closed ? 1 : 0);
}

PyObject* RingWaits(PyObject*, PyObject* args) {
  long long handle;
  if (!PyArg_ParseTuple(args, "L", &handle)) return nullptr;
  auto ring = LookupRing(handle);
  if (!ring) {
    PyErr_SetString(PyExc_ValueError, "unknown ring handle");
    return nullptr;
  }
  std::lock_guard<std::mutex> lock(ring->mu);
  return Py_BuildValue("(LLLL)", (long long)ring->put_wait_ns, (long long)ring->puts,
                       (long long)ring->get_wait_ns, (long long)ring->gets);
}

PyObject* RingTotals(PyObject*, PyObject*) {
  return Py_BuildValue("(LLLL)", (long long)g_put_wait_ns.load(), (long long)g_puts.load(),
                       (long long)g_get_wait_ns.load(), (long long)g_gets.load());
}

PyObject* RingDestroy(PyObject*, PyObject* args) {
  long long handle;
  if (!PyArg_ParseTuple(args, "L", &handle)) return nullptr;
  std::shared_ptr<Ring> ring;
  {
    std::lock_guard<std::mutex> lock(g_registry_mu);
    auto it = g_rings.find(handle);
    if (it != g_rings.end()) {
      ring = it->second;
      g_rings.erase(it);
    }
  }
  if (ring) {
    // Wake any blocked producers/consumers so their shared_ptr copies can
    // unwind; the Ring frees when the last in-flight call returns.
    {
      std::lock_guard<std::mutex> lock(ring->mu);
      ring->closed = true;
    }
    ring->not_empty.notify_all();
    ring->not_full.notify_all();
  }
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"ring_create", RingCreate, METH_VARARGS,
     "ring_create(slots, slot_bytes) -> handle"},
    {"ring_put_gray", RingPutGray, METH_VARARGS,
     "ring_put_gray(handle, rgb_u8) -> seq (packs BT.601 gray into a slot)"},
    {"ring_put_raw", RingPutRaw, METH_VARARGS,
     "ring_put_raw(handle, u8) -> seq"},
    {"ring_get_into", RingGetInto, METH_VARARGS,
     "ring_get_into(handle, out_u8, timeout_ms) -> seq | -1 timeout | -2 drained"},
    {"ring_close", RingClose, METH_VARARGS, "ring_close(handle)"},
    {"ring_stats", RingStats, METH_VARARGS,
     "ring_stats(handle) -> (occupied, slots, closed)"},
    {"ring_waits", RingWaits, METH_VARARGS,
     "ring_waits(handle) -> (put_wait_ns, puts, get_wait_ns, gets)"},
    {"ring_totals", RingTotals, METH_NOARGS,
     "ring_totals() -> (put_wait_ns, puts, get_wait_ns, gets) over every ring"},
    {"ring_destroy", RingDestroy, METH_VARARGS, "ring_destroy(handle)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_frame_ring",
    "Native frame-window ring buffer for stereo_vision_tpu_torch", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__frame_ring(void) { return PyModule_Create(&kModule); }
