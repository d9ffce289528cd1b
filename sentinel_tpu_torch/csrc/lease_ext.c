/* sentinel_torch_lease_ext — CPython extension for the token-lease
 * admission ring (the native twin of core/lease.py's LocalLease in
 * sentinel_tpu_torch; this package's own copy of the JAX package's
 * native/lease_ext.c, under its own module name so both can load in one
 * process).
 *
 * Built with the host C compiler at first use by
 * sentinel_tpu_torch/native.py into sentinel_tpu_torch/_build/, against
 * the running interpreter's include directory.
 *
 * Why an extension and not ctypes: the leased entry path budget is a few
 * µs per op and a ctypes trampoline costs more than the ring itself. A
 * PyMethodDef call keeps the ring's rotate/sum arithmetic well under a
 * microsecond.
 *
 * Thread-safety: all methods run WITH the GIL held (no
 * Py_BEGIN_ALLOW_THREADS); the GIL itself serializes the ring, like the
 * Python ring's threading.Lock. No internal mutex is needed or taken; a
 * caller that wants to release the GIL here must add one.
 *
 * Semantics are bucket-for-bucket identical to the Python ring
 * (device-exact DEFAULT admission: window_sum * 1000/interval + count
 * <= every threshold); tests/test_torch_lease.py compares the two
 * directly.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    PyObject_HEAD
    int64_t interval_ms;
    int64_t bucket_ms;
    int buckets;
    int nthresholds;
    double *thresholds;
    int64_t *starts;
    int64_t *counts;
} LeaseObject;

static void
Lease_dealloc(LeaseObject *self)
{
    PyMem_Free(self->thresholds);
    PyMem_Free(self->starts);
    PyMem_Free(self->counts);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int
Lease_init(LeaseObject *self, PyObject *args, PyObject *kwds)
{
    PyObject *thresholds;
    long long interval_ms;
    int buckets;
    static char *kwlist[] = {"thresholds", "interval_ms", "buckets", NULL};

    if (!PyArg_ParseTupleAndKeywords(args, kwds, "OLi", kwlist,
                                     &thresholds, &interval_ms, &buckets))
        return -1;
    if (interval_ms <= 0 || buckets <= 0 || interval_ms % buckets != 0) {
        PyErr_SetString(PyExc_ValueError, "bad ring geometry");
        return -1;
    }
    PyObject *seq = PySequence_Fast(thresholds, "thresholds not a sequence");
    if (seq == NULL)
        return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    self->interval_ms = interval_ms;
    self->buckets = buckets;
    self->bucket_ms = interval_ms / buckets;
    self->nthresholds = (int)n;
    self->thresholds = PyMem_Malloc(sizeof(double) * (size_t)(n > 0 ? n : 1));
    self->starts = PyMem_Malloc(sizeof(int64_t) * (size_t)buckets);
    self->counts = PyMem_Malloc(sizeof(int64_t) * (size_t)buckets);
    if (!self->thresholds || !self->starts || !self->counts) {
        Py_DECREF(seq);
        PyErr_NoMemory();
        return -1;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        double v = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(seq, i));
        if (v == -1.0 && PyErr_Occurred()) {
            Py_DECREF(seq);
            return -1;
        }
        self->thresholds[i] = v;
    }
    Py_DECREF(seq);
    for (int b = 0; b < buckets; b++) {
        self->starts[b] = -1;
        self->counts[b] = 0;
    }
    return 0;
}

/* Lazy bucket reset; returns the current index. Mirrors the Python
 * _rotate fast path: if the current bucket's start is right, the whole
 * ring is right. */
static inline int
rotate(LeaseObject *self, int64_t now_ms)
{
    int idx = (int)((now_ms / self->bucket_ms) % self->buckets);
    int64_t cur_start = now_ms - now_ms % self->bucket_ms;
    if (self->starts[idx] == cur_start)
        return idx;
    for (int b = 0; b < self->buckets; b++) {
        int64_t off = ((idx - b) % self->buckets + self->buckets)
                      % self->buckets;
        int64_t expected = cur_start - off * self->bucket_ms;
        if (self->starts[b] != expected) {
            self->starts[b] = expected;
            self->counts[b] = 0;
        }
    }
    return idx;
}

static inline double
used_qps(LeaseObject *self)
{
    int64_t total = 0;
    for (int b = 0; b < self->buckets; b++)
        total += self->counts[b];
    return (double)total * (1000.0 / (double)self->interval_ms);
}

static PyObject *
Lease_try_acquire(LeaseObject *self, PyObject *args)
{
    int count;
    long long now_ms;
    if (!PyArg_ParseTuple(args, "iL", &count, &now_ms))
        return NULL;
    int idx = rotate(self, now_ms);
    double used = used_qps(self);
    for (int i = 0; i < self->nthresholds; i++) {
        if (used + count > self->thresholds[i])
            Py_RETURN_FALSE;
    }
    self->counts[idx] += count;
    Py_RETURN_TRUE;
}

static PyObject *
Lease_add(LeaseObject *self, PyObject *args)
{
    int count;
    long long now_ms;
    if (!PyArg_ParseTuple(args, "iL", &count, &now_ms))
        return NULL;
    self->counts[rotate(self, now_ms)] += count;
    Py_RETURN_NONE;
}

static PyObject *
Lease_usage(LeaseObject *self, PyObject *args)
{
    long long now_ms;
    if (!PyArg_ParseTuple(args, "L", &now_ms))
        return NULL;
    rotate(self, now_ms);
    return PyFloat_FromDouble(used_qps(self));
}

static PyObject *
Lease_snapshot(LeaseObject *self, PyObject *Py_UNUSED(ignored))
{
    PyObject *starts = PyList_New(self->buckets);
    PyObject *counts = PyList_New(self->buckets);
    if (!starts || !counts) {
        Py_XDECREF(starts);
        Py_XDECREF(counts);
        return NULL;
    }
    for (int b = 0; b < self->buckets; b++) {
        PyList_SET_ITEM(starts, b, PyLong_FromLongLong(self->starts[b]));
        PyList_SET_ITEM(counts, b, PyLong_FromLongLong(self->counts[b]));
    }
    return Py_BuildValue("(NN)", starts, counts);
}

static PyObject *
Lease_seed(LeaseObject *self, PyObject *args)
{
    PyObject *starts, *counts;
    if (!PyArg_ParseTuple(args, "OO", &starts, &counts))
        return NULL;
    PyObject *s = PySequence_Fast(starts, "starts not a sequence");
    if (!s)
        return NULL;
    PyObject *c = PySequence_Fast(counts, "counts not a sequence");
    if (!c) {
        Py_DECREF(s);
        return NULL;
    }
    if (PySequence_Fast_GET_SIZE(s) != self->buckets ||
        PySequence_Fast_GET_SIZE(c) != self->buckets) {
        /* geometry mismatch: drop, like the Python ring */
        Py_DECREF(s);
        Py_DECREF(c);
        Py_RETURN_NONE;
    }
    for (int b = 0; b < self->buckets; b++) {
        long long sv = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(s, b));
        long long cv = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(c, b));
        if (PyErr_Occurred()) {
            Py_DECREF(s);
            Py_DECREF(c);
            return NULL;
        }
        self->starts[b] = sv;
        self->counts[b] = cv;
    }
    Py_DECREF(s);
    Py_DECREF(c);
    Py_RETURN_NONE;
}

static PyMethodDef Lease_methods[] = {
    {"try_acquire", (PyCFunction)Lease_try_acquire, METH_VARARGS,
     "try_acquire(count, now_ms) -> bool: device-exact DEFAULT admission"},
    {"add", (PyCFunction)Lease_add, METH_VARARGS,
     "add(count, now_ms): record a device-decided pass"},
    {"usage", (PyCFunction)Lease_usage, METH_VARARGS,
     "usage(now_ms) -> float: current window QPS"},
    {"snapshot", (PyCFunction)Lease_snapshot, METH_NOARGS,
     "snapshot() -> (starts, counts)"},
    {"seed", (PyCFunction)Lease_seed, METH_VARARGS,
     "seed(starts, counts): adopt a window wholesale"},
    {NULL, NULL, 0, NULL}
};

static PyTypeObject LeaseType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "sentinel_torch_lease_ext.LeaseRing",
    .tp_basicsize = sizeof(LeaseObject),
    .tp_dealloc = (destructor)Lease_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Native token-lease admission ring",
    .tp_methods = Lease_methods,
    .tp_init = (initproc)Lease_init,
    .tp_new = PyType_GenericNew,
};

static PyModuleDef lease_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "sentinel_torch_lease_ext",
    .m_doc = "Native token-lease admission ring (see sentinel_tpu_torch/core/lease.py)",
    .m_size = -1,
};

PyMODINIT_FUNC
PyInit_sentinel_torch_lease_ext(void)
{
    if (PyType_Ready(&LeaseType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&lease_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&LeaseType);
    if (PyModule_AddObject(m, "LeaseRing", (PyObject *)&LeaseType) < 0) {
        Py_DECREF(&LeaseType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
