/* C API of flexflow_tpu_torch: embeds CPython and drives the port.
 *
 * The reference embeds a Python interpreter inside a Legion task
 * (python/main.cc) and wraps a C++ core in C for cffi
 * (python/flexflow_c.cc); here the core is Python, so the C surface
 * embeds the interpreter.  Each function below takes the interpreter's
 * lock and calls one function of flexflow_tpu_torch/native/capi.py, which
 * holds the semantics; a handle's impl is the PyObject* it returned (a
 * reference the handle owns until its destroy call).  A Python error is
 * printed and the call returns -1, -1.0, a null handle or a null pointer.
 *
 * The build (flexflow_tpu_torch/utils/native.py, build_capi) defines
 * FF_PYTHON_EXE, the interpreter that built the library (its prefix and
 * site-packages are the ones the embedded interpreter starts from), and
 * FF_PACKAGE_ROOT, the directory holding flexflow_tpu_torch (put first on
 * sys.path, before whatever PYTHONPATH or site-packages name, so the
 * library runs the checkout it was built from).  sys.argv is the process's
 * own command line.  flexflow_finalize keeps the interpreter alive: CUDA
 * graphs and the allocator's pools are freed with the process.
 */

#include "flexflow_c.h"

#include <Python.h>

#include <cstdarg>
#include <cstdio>
#include <ctime>
#include <fstream>
#include <iterator>
#include <mutex>
#include <string>
#include <vector>

#ifndef FF_PYTHON_EXE
#define FF_PYTHON_EXE "python3"
#endif
#ifndef FF_PACKAGE_ROOT
#define FF_PACKAGE_ROOT ""
#endif

namespace {

PyObject* g_capi = nullptr;  // flexflow_tpu_torch.native.capi
std::once_flag g_once;

std::vector<std::string> own_argv() {
  std::ifstream f("/proc/self/cmdline", std::ios::binary);
  std::string all((std::istreambuf_iterator<char>(f)),
                  std::istreambuf_iterator<char>());
  std::vector<std::string> out;
  size_t start = 0;
  for (size_t i = 0; i < all.size(); i++) {
    if (all[i] == '\0') {
      out.push_back(all.substr(start, i - start));
      start = i + 1;
    }
  }
  if (out.empty()) out.push_back("flexflow_c");
  return out;
}

void init_once() {
  bool own = !Py_IsInitialized();
  if (own) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.parse_argv = 0;
    config.install_signal_handlers = 0;
    std::vector<std::string> args = own_argv();
    std::vector<char*> argv;
    for (auto& a : args) argv.push_back(const_cast<char*>(a.c_str()));
    PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                          FF_PYTHON_EXE);
    if (!PyStatus_Exception(st))
      st = PyConfig_SetBytesArgv(&config, (Py_ssize_t)argv.size(), argv.data());
    if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st)) {
      fprintf(stderr, "flexflow_c: the Python interpreter did not start: %s\n",
              st.err_msg ? st.err_msg : "(no message)");
      return;
    }
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* path = PySys_GetObject("path");  // borrowed
  if (path && *FF_PACKAGE_ROOT) {
    PyObject* root = PyUnicode_FromString(FF_PACKAGE_ROOT);
    if (root) PyList_Insert(path, 0, root);
    Py_XDECREF(root);
  }
  g_capi = PyImport_ImportModule("flexflow_tpu_torch.native.capi");
  if (!g_capi) PyErr_Print();
  PyGILState_Release(gil);
  if (own) PyEval_SaveThread();  // any thread may now take the lock
}

bool ensure_init() {
  std::call_once(g_once, init_once);
  return g_capi != nullptr;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }
  Gil(const Gil&) = delete;
  Gil& operator=(const Gil&) = delete;

 private:
  PyGILState_STATE state_;
};

PyObject* H(void* impl) { return static_cast<PyObject*>(impl); }

// Py_BuildValue's "O" for an optional handle: None when it is null.
PyObject* opt(void* impl) { return impl ? H(impl) : Py_None; }

// capi.<fn>(*args), ``args`` a tuple (stolen); the GIL held.  A new
// reference, or null with the error printed.
PyObject* call_args(const char* fn, PyObject* args) {
  if (!args) {  // most often a null handle: a call before this one failed
    PyErr_Clear();
    fprintf(stderr, "flexflow_c: %s: a null handle or argument\n", fn);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(g_capi, fn);
  PyObject* res = f ? PyObject_CallObject(f, args) : nullptr;
  Py_XDECREF(f);
  Py_DECREF(args);
  if (!res) PyErr_Print();
  return res;
}

PyObject* vcall(const char* fn, const char* fmt, va_list va) {
  return call_args(fn, Py_VaBuildValue(fmt, va));
}

// The helpers below start the interpreter if needed, take the GIL, call
// capi.<fn> with Py_BuildValue(fmt, ...) (fmt a tuple format) and convert.

int call_rc(const char* fn, const char* fmt, ...) {
  if (!ensure_init()) return -1;
  Gil gil;
  va_list va;
  va_start(va, fmt);
  PyObject* res = vcall(fn, fmt, va);
  va_end(va);
  Py_XDECREF(res);
  return res ? 0 : -1;
}

int64_t call_int(const char* fn, const char* fmt, ...) {
  if (!ensure_init()) return -1;
  Gil gil;
  va_list va;
  va_start(va, fmt);
  PyObject* res = vcall(fn, fmt, va);
  va_end(va);
  if (!res) return -1;
  int64_t out = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (PyErr_Occurred()) {
    PyErr_Print();
    return -1;
  }
  return out;
}

double call_double(const char* fn, const char* fmt, ...) {
  if (!ensure_init()) return -1.0;
  Gil gil;
  va_list va;
  va_start(va, fmt);
  PyObject* res = vcall(fn, fmt, va);
  va_end(va);
  if (!res) return -1.0;
  double out = PyFloat_AsDouble(res);
  Py_DECREF(res);
  if (PyErr_Occurred()) {
    PyErr_Print();
    return -1.0;
  }
  return out;
}

// A new handle: the returned object (null for None or an error).
void* call_handle(const char* fn, const char* fmt, ...) {
  if (!ensure_init()) return nullptr;
  Gil gil;
  va_list va;
  va_start(va, fmt);
  PyObject* res = vcall(fn, fmt, va);
  va_end(va);
  if (res == Py_None) {
    Py_DECREF(res);
    return nullptr;
  }
  return res;
}

// A handle's attribute as a new handle (null for None or an error).
void* attr_handle(void* impl, const char* name) {
  if (!impl || !ensure_init()) return nullptr;
  Gil gil;
  PyObject* res = PyObject_GetAttrString(H(impl), name);
  if (!res) PyErr_Print();
  if (res == Py_None) {
    Py_DECREF(res);
    return nullptr;
  }
  return res;
}

void release(void* impl) {
  if (!impl || !ensure_init()) return;
  Gil gil;
  Py_DECREF(H(impl));
}

unsigned long long addr(const void* p) {
  return (unsigned long long)(uintptr_t)p;
}

}  // namespace

extern "C" {

/* ---- runtime ------------------------------------------------------- */

int flexflow_init(void) { return ensure_init() ? 0 : -1; }

void flexflow_finalize(void) { /* the interpreter stays up (see the top) */ }

/* ---- config --------------------------------------------------------- */

flexflow_config_t flexflow_config_create(int batch_size, int epochs,
                                         int num_devices) {
  return {call_handle("config_create", "(iii)", batch_size, epochs,
                      num_devices)};
}

void flexflow_config_destroy(flexflow_config_t c) { release(c.impl); }

int flexflow_config_parse_args(flexflow_config_t c, int argc, char** argv) {
  if (!ensure_init()) return -1;
  Gil gil;
  PyObject* list = PyList_New(argc);
  for (int i = 0; list && i < argc; i++)
    PyList_SET_ITEM(list, i, PyUnicode_FromString(argv[i]));
  PyObject* res =
      list ? call_args("config_parse_args", Py_BuildValue("(OO)", H(c.impl), list))
           : nullptr;
  Py_XDECREF(list);
  Py_XDECREF(res);
  return res ? 0 : -1;
}

int flexflow_config_parse_args_default(flexflow_config_t c) {
  return call_rc("config_parse_args", "(OO)", H(c.impl), Py_None);
}

int flexflow_config_get_batch_size(flexflow_config_t c) {
  return (int)call_int("config_get", "(Os)", H(c.impl), "batch_size");
}
int flexflow_config_get_epochs(flexflow_config_t c) {
  return (int)call_int("config_get", "(Os)", H(c.impl), "epochs");
}
int flexflow_config_get_num_nodes(flexflow_config_t c) {
  return (int)call_int("config_get", "(Os)", H(c.impl), "num_nodes");
}
int flexflow_config_get_workers_per_node(flexflow_config_t c) {
  return (int)call_int("config_get", "(Os)", H(c.impl), "workers_per_node");
}

int flexflow_config_import_strategy(flexflow_config_t c, const char* path) {
  return call_rc("config_import_strategy", "(Os)", H(c.impl), path);
}

/* ---- model + tensors ------------------------------------------------ */

flexflow_model_t flexflow_model_create(flexflow_config_t c) {
  return {call_handle("model_create", "(O)", H(c.impl))};
}

void flexflow_model_destroy(flexflow_model_t m) { release(m.impl); }

flexflow_tensor_t flexflow_tensor_create(flexflow_model_t m, int ndims,
                                         const int* dims, const char* dtype) {
  if (!ensure_init()) return {nullptr};
  Gil gil;
  PyObject* shape = PyTuple_New(ndims);
  for (int i = 0; shape && i < ndims; i++)
    PyTuple_SET_ITEM(shape, i, PyLong_FromLong(dims[i]));
  PyObject* res = shape ? call_args("tensor_create", Py_BuildValue(
                                        "(OOz)", H(m.impl), shape, dtype))
                        : nullptr;
  Py_XDECREF(shape);
  return {res};
}

void flexflow_tensor_destroy(flexflow_tensor_t t) { release(t.impl); }

/* ---- layer builders -------------------------------------------------- */

flexflow_tensor_t flexflow_model_add_conv2d(
    flexflow_model_t m, flexflow_tensor_t input, int out_channels,
    int kernel_h, int kernel_w, int stride_h, int stride_w, int padding_h,
    int padding_w, int activation, int use_bias, const char* name) {
  return {call_handle("add_conv2d", "(OOiiiiiiiiiz)", H(m.impl),
                      H(input.impl), out_channels, kernel_h, kernel_w,
                      stride_h, stride_w, padding_h, padding_w, activation,
                      use_bias, name)};
}

flexflow_tensor_t flexflow_model_add_pool2d(
    flexflow_model_t m, flexflow_tensor_t input, int kernel_h, int kernel_w,
    int stride_h, int stride_w, int padding_h, int padding_w, int pool_max,
    const char* name) {
  return {call_handle("add_pool2d", "(OOiiiiiiiz)", H(m.impl), H(input.impl),
                      kernel_h, kernel_w, stride_h, stride_w, padding_h,
                      padding_w, pool_max, name)};
}

flexflow_tensor_t flexflow_model_add_dense(flexflow_model_t m,
                                           flexflow_tensor_t input,
                                           int out_dim, int activation,
                                           int use_bias, const char* name) {
  return {call_handle("add_dense", "(OOiiiz)", H(m.impl), H(input.impl),
                      out_dim, activation, use_bias, name)};
}

static flexflow_tensor_t unary(flexflow_model_t m, const char* method,
                               flexflow_tensor_t input, const char* name) {
  return {call_handle("add_layer", "(Os(O)z)", H(m.impl), method,
                      H(input.impl), name)};
}

static flexflow_tensor_t binary(flexflow_model_t m, const char* method,
                                flexflow_tensor_t a, flexflow_tensor_t b,
                                const char* name) {
  return {call_handle("add_layer", "(Os(OO)z)", H(m.impl), method, H(a.impl),
                      H(b.impl), name)};
}

flexflow_tensor_t flexflow_model_add_flat(flexflow_model_t m,
                                          flexflow_tensor_t input,
                                          const char* name) {
  return unary(m, "flat", input, name);
}

flexflow_tensor_t flexflow_model_add_softmax(flexflow_model_t m,
                                             flexflow_tensor_t input,
                                             const char* name) {
  return unary(m, "softmax", input, name);
}

flexflow_tensor_t flexflow_model_add_embedding(flexflow_model_t m,
                                               flexflow_tensor_t input,
                                               int num_entries, int out_dim,
                                               int aggr_sum, const char* name) {
  return {call_handle("add_embedding", "(OOiiiz)", H(m.impl), H(input.impl),
                      num_entries, out_dim, aggr_sum, name)};
}

flexflow_tensor_t flexflow_model_add_concat(flexflow_model_t m, int n,
                                            const flexflow_tensor_t* inputs,
                                            int axis, const char* name) {
  if (!ensure_init()) return {nullptr};
  Gil gil;
  PyObject* list = PyList_New(n);
  for (int i = 0; list && i < n; i++) {
    PyObject* t = inputs[i].impl ? H(inputs[i].impl) : Py_None;
    Py_INCREF(t);
    PyList_SET_ITEM(list, i, t);
  }
  PyObject* res = list ? call_args("add_concat", Py_BuildValue(
                                       "(OOiz)", H(m.impl), list, axis, name))
                       : nullptr;
  Py_XDECREF(list);
  return {res};
}

flexflow_tensor_t flexflow_model_add_add(flexflow_model_t m,
                                         flexflow_tensor_t a,
                                         flexflow_tensor_t b,
                                         const char* name) {
  return binary(m, "add", a, b, name);
}
flexflow_tensor_t flexflow_model_add_subtract(flexflow_model_t m,
                                              flexflow_tensor_t a,
                                              flexflow_tensor_t b,
                                              const char* name) {
  return binary(m, "subtract", a, b, name);
}
flexflow_tensor_t flexflow_model_add_multiply(flexflow_model_t m,
                                              flexflow_tensor_t a,
                                              flexflow_tensor_t b,
                                              const char* name) {
  return binary(m, "multiply", a, b, name);
}
flexflow_tensor_t flexflow_model_add_divide(flexflow_model_t m,
                                            flexflow_tensor_t a,
                                            flexflow_tensor_t b,
                                            const char* name) {
  return binary(m, "divide", a, b, name);
}
flexflow_tensor_t flexflow_model_add_relu(flexflow_model_t m,
                                          flexflow_tensor_t input,
                                          const char* name) {
  return unary(m, "relu", input, name);
}
flexflow_tensor_t flexflow_model_add_sigmoid(flexflow_model_t m,
                                             flexflow_tensor_t input,
                                             const char* name) {
  return unary(m, "sigmoid", input, name);
}
flexflow_tensor_t flexflow_model_add_tanh(flexflow_model_t m,
                                          flexflow_tensor_t input,
                                          const char* name) {
  return unary(m, "tanh", input, name);
}
flexflow_tensor_t flexflow_model_add_elu(flexflow_model_t m,
                                         flexflow_tensor_t input,
                                         const char* name) {
  return unary(m, "elu", input, name);
}
flexflow_tensor_t flexflow_model_add_exp(flexflow_model_t m,
                                         flexflow_tensor_t input,
                                         const char* name) {
  return unary(m, "exp", input, name);
}

flexflow_tensor_t flexflow_model_add_batch_norm(flexflow_model_t m,
                                                flexflow_tensor_t input,
                                                int relu, const char* name) {
  return {call_handle("add_layer", "(Os(O)z{s:O})", H(m.impl), "batch_norm",
                      H(input.impl), name, "relu", relu ? Py_True : Py_False)};
}

flexflow_tensor_t flexflow_model_add_dropout(flexflow_model_t m,
                                             flexflow_tensor_t input,
                                             double rate, int seed,
                                             const char* name) {
  return {call_handle("add_layer", "(Os(Od)z{s:i})", H(m.impl), "dropout",
                      H(input.impl), rate, name, "seed", seed)};
}

flexflow_tensor_t flexflow_model_add_mse_loss(flexflow_model_t m,
                                              flexflow_tensor_t logits,
                                              flexflow_tensor_t labels,
                                              const char* reduction,
                                              const char* name) {
  return {call_handle("add_layer", "(Os(OO)z{s:s})", H(m.impl), "mse_loss",
                      H(logits.impl), H(labels.impl), name, "reduction",
                      reduction ? reduction : "average")};
}

/* ---- compile + drivers ---------------------------------------------- */

int flexflow_model_compile(flexflow_model_t m, const char* optimizer,
                           double lr, const char* loss, const char** metrics,
                           int num_metrics) {
  if (!ensure_init()) return -1;
  Gil gil;
  PyObject* names = PyList_New(num_metrics);
  for (int i = 0; names && i < num_metrics; i++)
    PyList_SET_ITEM(names, i, PyUnicode_FromString(metrics[i]));
  PyObject* res =
      names ? call_args("compile_model", Py_BuildValue("(OzdsO)", H(m.impl),
                                                       optimizer, lr, loss, names))
            : nullptr;
  Py_XDECREF(names);
  Py_XDECREF(res);
  return res ? 0 : -1;
}

static int run(flexflow_model_t m, const char* method) {
  return call_rc("run", "(Os)", H(m.impl), method);
}

int flexflow_model_init_layers(flexflow_model_t m) {
  return run(m, "init_layers");
}

int flexflow_model_set_input_f32(flexflow_model_t m, flexflow_tensor_t t,
                                 const float* data, int64_t count) {
  return call_rc("set_input", "(OOKLi)", H(m.impl), H(t.impl), addr(data),
                 (long long)count, 1);
}

int flexflow_model_set_input_i32(flexflow_model_t m, flexflow_tensor_t t,
                                 const int32_t* data, int64_t count) {
  return call_rc("set_input", "(OOKLi)", H(m.impl), H(t.impl), addr(data),
                 (long long)count, 0);
}

int flexflow_model_set_label_i32(flexflow_model_t m, const int32_t* data,
                                 int64_t count) {
  return call_rc("set_label", "(OKLi)", H(m.impl), addr(data),
                 (long long)count, 0);
}

int flexflow_model_set_label_f32(flexflow_model_t m, const float* data,
                                 int64_t count) {
  return call_rc("set_label", "(OKLi)", H(m.impl), addr(data),
                 (long long)count, 1);
}

int flexflow_model_forward(flexflow_model_t m) { return run(m, "forward"); }
int flexflow_model_zero_gradients(flexflow_model_t m) {
  return run(m, "zero_gradients");
}
int flexflow_model_backward(flexflow_model_t m) { return run(m, "backward"); }
int flexflow_model_update(flexflow_model_t m) { return run(m, "update"); }
int flexflow_model_sync(flexflow_model_t m) { return run(m, "sync"); }
void flexflow_model_reset_metrics(flexflow_model_t m) {
  run(m, "reset_metrics");
}
int flexflow_model_train_iteration(flexflow_model_t m) {
  return run(m, "train_iteration");
}

/* ---- metrics --------------------------------------------------------- */

double flexflow_model_get_accuracy(flexflow_model_t m, int64_t* train_all,
                                   int64_t* train_correct) {
  if (!ensure_init()) return -1.0;
  Gil gil;
  PyObject* res = call_args("accuracy", Py_BuildValue("(O)", H(m.impl)));
  double acc = -1.0;
  long long all = 0, correct = 0;
  if (res && PyArg_ParseTuple(res, "dLL", &acc, &all, &correct)) {
    if (train_all) *train_all = all;
    if (train_correct) *train_correct = correct;
  } else if (res) {
    PyErr_Print();
    acc = -1.0;
  }
  Py_XDECREF(res);
  return acc;
}

double flexflow_model_get_metric(flexflow_model_t m, const char* name) {
  return call_double("metric", "(Os)", H(m.impl), name);
}

flexflow_perf_metrics_t flexflow_model_get_perf_metrics(flexflow_model_t m) {
  return {call_handle("run", "(Os)", H(m.impl), "get_metrics")};
}

void flexflow_per_metrics_destroy(flexflow_perf_metrics_t p) {
  release(p.impl);
}

float flexflow_per_metrics_get_accuracy(flexflow_perf_metrics_t p) {
  void* acc = attr_handle(p.impl, "accuracy");
  if (!acc) return -1.0f;
  Gil gil;
  float out = (float)PyFloat_AsDouble(H(acc));
  Py_DECREF(H(acc));
  return out;
}

int flexflow_model_compute_metrics(flexflow_model_t m) {
  /* the metrics accumulate on the device inside the step; this folds
     them into the host PerfMetrics (reference: UPDATE_METRICS_TASK) */
  return run(m, "get_metrics");
}

/* ---- weights --------------------------------------------------------- */

int64_t flexflow_parameter_get_volume(flexflow_model_t m, const char* op_name,
                                      const char* weight_name) {
  return call_int("parameter_volume", "(Oss)", H(m.impl), op_name,
                  weight_name);
}

int flexflow_model_get_parameter_f32(flexflow_model_t m, const char* op_name,
                                     const char* weight_name, float* out,
                                     int64_t count) {
  return call_rc("get_parameter", "(OssKL)", H(m.impl), op_name, weight_name,
                 addr(out), (long long)count);
}

int flexflow_model_set_parameter_f32(flexflow_model_t m, const char* op_name,
                                     const char* weight_name,
                                     const float* data, int64_t count) {
  return call_rc("set_parameter", "(OssKL)", H(m.impl), op_name, weight_name,
                 addr(data), (long long)count);
}

/* ---- strategy files + checkpoints ----------------------------------- */

int flexflow_model_export_strategy(flexflow_model_t m, const char* path) {
  return call_rc("export_strategy", "(Os)", H(m.impl), path);
}

int flexflow_model_save(flexflow_model_t m, const char* path) {
  return call_rc("run", "(Oss)", H(m.impl), "save", path);
}

int flexflow_model_load(flexflow_model_t m, const char* path) {
  return call_rc("run", "(Oss)", H(m.impl), "load", path);
}

/* ---- tensor introspection ------------------------------------------- */

int flexflow_tensor_get_dims(flexflow_tensor_t t, int* dims) {
  void* d = attr_handle(t.impl, "dims");
  if (!d) return -1;
  Gil gil;
  int nd = (int)PyTuple_Size(H(d));
  for (int i = 0; i < nd && i < 8; i++)
    dims[i] = (int)PyLong_AsLong(PyTuple_GetItem(H(d), i));
  Py_DECREF(H(d));
  return nd;
}

int flexflow_tensor_get_num_dims(flexflow_tensor_t t) {
  void* d = attr_handle(t.impl, "dims");
  if (!d) return -1;
  Gil gil;
  int nd = (int)PyTuple_Size(H(d));
  Py_DECREF(H(d));
  return nd;
}

int flexflow_tensor_get_data_type(flexflow_tensor_t t) {
  return (int)call_int("data_type", "(O)", H(t.impl));
}

flexflow_op_t flexflow_tensor_get_owner_op(flexflow_tensor_t t) {
  return {attr_handle(t.impl, "owner_op")};
}

/* ---- optimizer objects ---------------------------------------------- */

flexflow_sgd_optimizer_t flexflow_sgd_optimizer_create(
    flexflow_model_t m, double lr, double momentum, int nesterov,
    double weight_decay) {
  (void)m; /* the reference binds the model at create; here compile does */
  return {call_handle("sgd_create", "(ddid)", lr, momentum, nesterov,
                      weight_decay)};
}

void flexflow_sgd_optimizer_destroy(flexflow_sgd_optimizer_t o) {
  release(o.impl);
}

static void set_float_attr(void* impl, const char* name, double value) {
  if (!impl || !ensure_init()) return;
  Gil gil;
  PyObject* v = PyFloat_FromDouble(value);
  if (!v || PyObject_SetAttrString(H(impl), name, v) != 0) PyErr_Print();
  Py_XDECREF(v);
}

void flexflow_sgd_optimizer_set_lr(flexflow_sgd_optimizer_t o, double lr) {
  set_float_attr(o.impl, "lr", lr);
}

flexflow_adam_optimizer_t flexflow_adam_optimizer_create(
    flexflow_model_t m, double alpha, double beta1, double beta2,
    double weight_decay, double epsilon) {
  (void)m;
  return {call_handle("adam_create", "(ddddd)", alpha, beta1, beta2,
                      weight_decay, epsilon)};
}

void flexflow_adam_optimizer_destroy(flexflow_adam_optimizer_t o) {
  release(o.impl);
}

void flexflow_adam_optimizer_set_lr(flexflow_adam_optimizer_t o, double lr) {
  set_float_attr(o.impl, "alpha", lr);
}

int flexflow_model_set_sgd_optimizer(flexflow_model_t m,
                                     flexflow_sgd_optimizer_t o) {
  return call_rc("set_optimizer", "(OO)", H(m.impl), H(o.impl));
}

int flexflow_model_set_adam_optimizer(flexflow_model_t m,
                                      flexflow_adam_optimizer_t o) {
  return call_rc("set_optimizer", "(OO)", H(m.impl), H(o.impl));
}

/* ---- initializer objects -------------------------------------------- */

flexflow_initializer_t flexflow_initializer_create_null(void) {
  return {nullptr}; /* null: the op's default initializer */
}

flexflow_glorot_uniform_initializer_t
flexflow_glorot_uniform_initializer_create(int seed) {
  return {call_handle("initializer", "(si)", "glorot", seed)};
}
void flexflow_glorot_uniform_initializer_destroy(
    flexflow_glorot_uniform_initializer_t i) {
  release(i.impl);
}

flexflow_zero_initializer_t flexflow_zero_initializer_create(void) {
  return {call_handle("initializer", "(s)", "zero")};
}
void flexflow_zero_initializer_destroy(flexflow_zero_initializer_t i) {
  release(i.impl);
}

flexflow_uniform_initializer_t flexflow_uniform_initializer_create(
    int seed, float min_val, float max_val) {
  return {call_handle("initializer", "(sidd)", "uniform", seed,
                      (double)min_val, (double)max_val)};
}
void flexflow_uniform_initializer_destroy(flexflow_uniform_initializer_t i) {
  release(i.impl);
}

flexflow_norm_initializer_t flexflow_norm_initializer_create(int seed,
                                                             float mean,
                                                             float stddev) {
  return {call_handle("initializer", "(sidd)", "norm", seed, (double)mean,
                      (double)stddev)};
}
void flexflow_norm_initializer_destroy(flexflow_norm_initializer_t i) {
  release(i.impl);
}

flexflow_tensor_t flexflow_model_add_dense_v2(
    flexflow_model_t m, flexflow_tensor_t input, int out_dim, int activation,
    int use_bias, flexflow_initializer_t kernel_init,
    flexflow_initializer_t bias_init, const char* name) {
  return {call_handle("add_dense", "(OOiiizOO)", H(m.impl), H(input.impl),
                      out_dim, activation, use_bias, name, opt(kernel_init.impl),
                      opt(bias_init.impl))};
}

flexflow_tensor_t flexflow_model_add_conv2d_v2(
    flexflow_model_t m, flexflow_tensor_t input, int out_channels,
    int kernel_h, int kernel_w, int stride_h, int stride_w, int padding_h,
    int padding_w, int activation, int use_bias,
    flexflow_initializer_t kernel_init, flexflow_initializer_t bias_init,
    const char* name) {
  return {call_handle("add_conv2d", "(OOiiiiiiiiizOO)", H(m.impl),
                      H(input.impl), out_channels, kernel_h, kernel_w,
                      stride_h, stride_w, padding_h, padding_w, activation,
                      use_bias, name, opt(kernel_init.impl),
                      opt(bias_init.impl))};
}

flexflow_tensor_t flexflow_model_add_expert_mlp(
    flexflow_model_t m, flexflow_tensor_t input, int num_experts,
    int hidden_size, double capacity_factor, const char* name) {
  return {call_handle("add_layer", "(Os(Oii)z{s:d})", H(m.impl), "expert_mlp",
                      H(input.impl), num_experts, hidden_size, name,
                      "capacity_factor", capacity_factor)};
}

/* ---- NetConfig ------------------------------------------------------- */

flexflow_net_config_t flexflow_net_config_create(void) {
  return {call_handle("net_config", "()")};
}

void flexflow_net_config_destroy(flexflow_net_config_t c) { release(c.impl); }

const char* flexflow_net_config_get_dataset_path(flexflow_net_config_t c) {
  if (!c.impl || !ensure_init()) return "";
  Gil gil;
  const char* s = PyUnicode_AsUTF8(H(c.impl)); /* lives as long as c */
  if (!s) {
    PyErr_Print();
    return "";
  }
  return s;
}

/* ---- deferred-shape (functional) builders --------------------------- */

flexflow_op_t flexflow_model_add_conv2d_no_inout(
    flexflow_model_t m, int out_channels, int kernel_h, int kernel_w,
    int stride_h, int stride_w, int padding_h, int padding_w, int activation,
    int use_bias, const char* name) {
  (void)m;
  return {call_handle("deferred", "(s(iiiiiii){s:i,s:i}z)", "conv2d",
                      out_channels, kernel_h, kernel_w, stride_h, stride_w,
                      padding_h, padding_w, "activation", activation,
                      "use_bias", use_bias, name)};
}

flexflow_op_t flexflow_model_add_dense_no_inout(flexflow_model_t m,
                                                int out_dim, int activation,
                                                int use_bias,
                                                const char* name) {
  (void)m;
  return {call_handle("deferred", "(s(i){s:i,s:i}z)", "dense", out_dim,
                      "activation", activation, "use_bias", use_bias, name)};
}

flexflow_op_t flexflow_model_add_pool2d_no_inout(
    flexflow_model_t m, int kernel_h, int kernel_w, int stride_h,
    int stride_w, int padding_h, int padding_w, int pool_max,
    const char* name) {
  (void)m;
  return {call_handle("deferred", "(s(iiiiii){s:i}z)", "pool2d", kernel_h,
                      kernel_w, stride_h, stride_w, padding_h, padding_w,
                      "pool_max", pool_max, name)};
}

flexflow_op_t flexflow_model_add_flat_no_inout(flexflow_model_t m,
                                               const char* name) {
  (void)m;
  return {call_handle("deferred", "(s(){}z)", "flat", name)};
}

flexflow_tensor_t flexflow_op_init_inout(flexflow_op_t op, flexflow_model_t m,
                                         flexflow_tensor_t input) {
  return {call_handle("op_init_inout", "(OOO)", H(op.impl), H(m.impl),
                      H(input.impl))};
}

int flexflow_op_add_to_model(flexflow_op_t op, flexflow_model_t m) {
  (void)m; /* a layer joins the graph when it is built */
  return call_int("op_added", "(O)", H(op.impl)) == 1 ? 0 : -1;
}

int flexflow_op_init(flexflow_op_t op, flexflow_model_t m) {
  (void)op; /* each op's weights are made by flexflow_model_init_layers */
  (void)m;
  return 0;
}

int flexflow_op_forward(flexflow_op_t op, flexflow_model_t m) {
  (void)op; /* the whole step runs at once; an op's forward is the
               model's forward over the staged batch */
  return run(m, "forward");
}

/* ---- op / parameter handles ------------------------------------------ */

int flexflow_model_get_num_layers(flexflow_model_t m) {
  void* ops = attr_handle(m.impl, "ops");
  if (!ops) return -1;
  Gil gil;
  int n = (int)PyList_Size(H(ops));
  Py_DECREF(H(ops));
  return n;
}

flexflow_op_t flexflow_model_get_layer_by_id(flexflow_model_t m, int id) {
  if (!m.impl || !ensure_init()) return {nullptr};
  Gil gil;
  PyObject* ops = PyObject_GetAttrString(H(m.impl), "ops");
  PyObject* op = ops ? PySequence_GetItem(ops, id) : nullptr;
  if (!op) PyErr_Print();
  Py_XDECREF(ops);
  return {op};
}

void flexflow_op_destroy(flexflow_op_t op) { release(op.impl); }

flexflow_tensor_t flexflow_op_get_input_by_id(flexflow_op_t op, int id) {
  return {call_handle("op_tensor", "(Osi)", H(op.impl), "inputs", id)};
}

flexflow_tensor_t flexflow_op_get_output_by_id(flexflow_op_t op, int id) {
  return {call_handle("op_tensor", "(Osi)", H(op.impl), "outputs", id)};
}

flexflow_parameter_t flexflow_op_get_parameter_by_id(flexflow_op_t op,
                                                     int id) {
  return {call_handle("op_parameter", "(Oi)", H(op.impl), id)};
}

flexflow_parameter_t flexflow_model_get_parameter_by_id(flexflow_model_t m,
                                                        int id) {
  return {call_handle("model_parameter", "(Oi)", H(m.impl), id)};
}

void flexflow_parameter_destroy(flexflow_parameter_t p) { release(p.impl); }

int64_t flexflow_parameter_get_volume_v2(flexflow_parameter_t p) {
  return call_int("run", "(Os)", H(p.impl), "volume");
}

int flexflow_parameter_get_weights_float(flexflow_parameter_t p, float* out,
                                         int64_t count) {
  return call_rc("parameter_get", "(OKL)", H(p.impl), addr(out),
                 (long long)count);
}

int flexflow_parameter_set_weights_float(flexflow_parameter_t p,
                                         const float* data, int64_t count) {
  return call_rc("parameter_set", "(OKL)", H(p.impl), addr(data),
                 (long long)count);
}

/* ---- label tensor / layers / prefetch -------------------------------- */

flexflow_tensor_t flexflow_model_get_label_tensor(flexflow_model_t m) {
  return {attr_handle(m.impl, "label_tensor")};
}

void flexflow_model_print_layers(flexflow_model_t m, int id) {
  fflush(stdout);
  call_rc("print_layers", "(Oi)", H(m.impl), id);
}

int flexflow_model_prefetch(flexflow_model_t m) {
  (void)m; /* set_batch's copy to the device is already asynchronous */
  return 0;
}

/* ---- tracing + timing ------------------------------------------------ */

void flexflow_begin_trace(flexflow_model_t m, int trace_id) {
  (void)m; /* the step is captured once as a CUDA graph and replayed */
  (void)trace_id;
}

void flexflow_end_trace(flexflow_model_t m, int trace_id) {
  (void)m;
  (void)trace_id;
}

double flexflow_get_current_time(flexflow_model_t m) {
  (void)m;
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e6 + ts.tv_nsec * 1e-3; /* microseconds */
}

/* ---- raw-ptr attach + inline map ------------------------------------- */

int flexflow_tensor_attach_raw_ptr(flexflow_model_t m, flexflow_tensor_t t,
                                   void* ptr, int64_t count, int is_float) {
  return call_rc("attach", "(OOKLi)", H(m.impl), H(t.impl), addr(ptr),
                 (long long)count, is_float);
}

int flexflow_tensor_detach_raw_ptr(flexflow_model_t m, flexflow_tensor_t t) {
  return call_rc("detach", "(OO)", H(m.impl), H(t.impl));
}

int flexflow_tensor_inline_map(flexflow_model_t m, flexflow_tensor_t t) {
  return call_rc("inline_map", "(OO)", H(m.impl), H(t.impl));
}

void flexflow_tensor_inline_unmap(flexflow_model_t m, flexflow_tensor_t t) {
  call_rc("inline_unmap", "(OO)", H(m.impl), H(t.impl));
}

int flexflow_tensor_is_mapped(flexflow_model_t m, flexflow_tensor_t t) {
  return (int)call_int("is_mapped", "(OO)", H(m.impl), H(t.impl));
}

float* flexflow_tensor_get_raw_ptr_float(flexflow_model_t m,
                                         flexflow_tensor_t t) {
  int64_t p = call_int("raw_ptr", "(OO)", H(m.impl), H(t.impl));
  return p > 0 ? (float*)(uintptr_t)p : nullptr;
}

int32_t* flexflow_tensor_get_raw_ptr_int32(flexflow_model_t m,
                                           flexflow_tensor_t t) {
  int64_t p = call_int("raw_ptr", "(OO)", H(m.impl), H(t.impl));
  return p > 0 ? (int32_t*)(uintptr_t)p : nullptr;
}

/* ---- dataloader handles ---------------------------------------------- */

flexflow_dataloader_4d_t flexflow_dataloader_4d_create(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    const int32_t* full_label, int64_t num_samples) {
  return {call_handle("loader_create", "(OOKiKLi)", H(m.impl),
                      H(input.impl), addr(full_input), 1, addr(full_label),
                      (long long)num_samples, 0)};
}

flexflow_dataloader_4d_t flexflow_dataloader_4d_create_v2(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    int64_t num_samples) {
  return {call_handle("loader_create", "(OOKiKLi)", H(m.impl),
                      H(input.impl), addr(full_input), 1, 0ULL,
                      (long long)num_samples, 0)};
}

static int loader_next(void* impl) {
  return call_rc("run", "(Os)", H(impl), "next_batch");
}

static void loader_reset(void* impl) {
  if (!impl || !ensure_init()) return;
  Gil gil;
  PyObject* z = PyLong_FromLong(0);
  if (!z || PyObject_SetAttrString(H(impl), "next", z) != 0) PyErr_Print();
  Py_XDECREF(z);
}

static int64_t loader_num(void* impl) {
  void* n = attr_handle(impl, "num");
  if (!n) return -1;
  Gil gil;
  int64_t out = PyLong_AsLongLong(H(n));
  Py_DECREF(H(n));
  return out;
}

static void loader_set_num(void* impl, int64_t num) {
  if (!impl || !ensure_init()) return;
  Gil gil;
  PyObject* v = PyLong_FromLongLong(num);
  if (!v || PyObject_SetAttrString(H(impl), "num", v) != 0) PyErr_Print();
  Py_XDECREF(v);
}

void flexflow_dataloader_4d_destroy(flexflow_dataloader_4d_t d) {
  release(d.impl);
}
void flexflow_dataloader_4d_reset(flexflow_dataloader_4d_t d) {
  loader_reset(d.impl);
}
int flexflow_dataloader_4d_next_batch(flexflow_dataloader_4d_t d,
                                      flexflow_model_t m) {
  (void)m; /* the loader stages into the model it was made for */
  return loader_next(d.impl);
}
int64_t flexflow_dataloader_4d_get_num_samples(flexflow_dataloader_4d_t d) {
  return loader_num(d.impl);
}
void flexflow_dataloader_4d_set_num_samples(flexflow_dataloader_4d_t d,
                                            int64_t n) {
  loader_set_num(d.impl, n);
}

flexflow_dataloader_2d_t flexflow_dataloader_2d_create(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    const int32_t* full_label, int64_t num_samples) {
  return {call_handle("loader_create", "(OOKiKLi)", H(m.impl),
                      H(input.impl), addr(full_input), 1, addr(full_label),
                      (long long)num_samples, 0)};
}

flexflow_dataloader_2d_t flexflow_dataloader_2d_create_v2(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    int64_t num_samples) {
  return {call_handle("loader_create", "(OOKiKLi)", H(m.impl),
                      H(input.impl), addr(full_input), 1, 0ULL,
                      (long long)num_samples, 0)};
}

void flexflow_dataloader_2d_destroy(flexflow_dataloader_2d_t d) {
  release(d.impl);
}
void flexflow_dataloader_2d_reset(flexflow_dataloader_2d_t d) {
  loader_reset(d.impl);
}
int flexflow_dataloader_2d_next_batch(flexflow_dataloader_2d_t d,
                                      flexflow_model_t m) {
  (void)m;
  return loader_next(d.impl);
}
int64_t flexflow_dataloader_2d_get_num_samples(flexflow_dataloader_2d_t d) {
  return loader_num(d.impl);
}
void flexflow_dataloader_2d_set_num_samples(flexflow_dataloader_2d_t d,
                                            int64_t n) {
  loader_set_num(d.impl, n);
}

flexflow_single_dataloader_t flexflow_single_dataloader_create(
    flexflow_model_t m, flexflow_tensor_t t, const void* full_data,
    int64_t num_samples, int is_float, int is_label) {
  return {call_handle("loader_create", "(OOKiKLi)", H(m.impl), H(t.impl),
                      addr(full_data), is_float, 0ULL, (long long)num_samples,
                      is_label)};
}

void flexflow_single_dataloader_destroy(flexflow_single_dataloader_t d) {
  release(d.impl);
}
void flexflow_single_dataloader_reset(flexflow_single_dataloader_t d) {
  loader_reset(d.impl);
}
int flexflow_single_dataloader_next_batch(flexflow_single_dataloader_t d,
                                          flexflow_model_t m) {
  (void)m;
  return loader_next(d.impl);
}
int64_t flexflow_single_dataloader_get_num_samples(
    flexflow_single_dataloader_t d) {
  return loader_num(d.impl);
}
void flexflow_single_dataloader_set_num_samples(flexflow_single_dataloader_t d,
                                                int64_t n) {
  loader_set_num(d.impl, n);
}

}  // extern "C"
