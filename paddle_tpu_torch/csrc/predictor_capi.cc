// Serving C ABI over the port's inference Predictor: Paddle's capi_exp
// surface (pd_config.h, pd_inference_api) as a flat C ABI that a C program
// reaches with dlopen. Counterpart of paddle_tpu/csrc/predictor_capi.cc,
// with the same extern "C" names and signatures; it drives
// paddle_tpu_torch.inference.create_predictor instead of the JAX one.
//
// The library embeds a CPython interpreter (or joins one already running
// in the process) as the control plane: tensor data crosses as raw
// buffers, and the compute is the Predictor's (an exported program
// replayed as one CUDA graph a shape on the card).
//
//   PDT_Init(platform)                 "" = the card, "cpu" = the CPU
//   PDT_ConfigCreate / SetModel / Destroy
//   PDT_PredictorCreate / Destroy
//   PDT_PredictorGetInputNum/Name, GetOutputNum/Name
//   PDT_PredictorGetInputHandle / GetOutputHandle, PDT_TensorDestroy
//   PDT_TensorReshape / CopyFromCpuFloat / CopyFromCpuInt64 /
//   CopyToCpuFloat / GetShape
//   PDT_PredictorRun
//   PDT_GetLastError
//
// The interpreter: PDT_PYTHON, when set, names the Python executable whose
// installation (a virtual environment included) the embedded interpreter
// uses; otherwise Python finds itself as `python3` on PATH.
// Thread model: every entry point takes the GIL (PyGILState_Ensure), so
// calls from several threads serialise on the interpreter.
// Build: utils/native.py build_capi() (g++ with the running Python's
// headers and libpython).
#include <Python.h>

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

std::string g_last_error;
std::string g_platform;  // "" (the card) or "cpu"

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  g_last_error = "unknown python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) g_last_error = c;
      Py_DECREF(s);
    }
    PyErr_Clear();
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

struct GIL {
  PyGILState_STATE st;
  GIL() : st(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(st); }
};

bool start_interpreter() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  const char* exe = std::getenv("PDT_PYTHON");
  if (exe && exe[0]) {
    PyStatus st =
        PyConfig_SetBytesString(&config, &config.program_name, exe);
    if (PyStatus_Exception(st)) {
      PyConfig_Clear(&config);
      g_last_error = "PDT_PYTHON could not be decoded";
      return false;
    }
  }
  PyStatus st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    g_last_error = st.err_msg ? st.err_msg : "Python failed to initialise";
    return false;
  }
  // hand the GIL back so the GIL guards below work from any thread
  PyEval_SaveThread();
  return true;
}

struct Config {
  std::string prog_path;
};

struct Predictor {
  PyObject* obj = nullptr;  // paddle_tpu_torch.inference.Predictor
  std::vector<std::string> input_names, output_names;
};

struct TensorHandle {
  PyObject* obj = nullptr;  // inference._IOHandle
};

bool fetch_names(PyObject* pred, const char* method,
                 std::vector<std::string>* out) {
  PyObject* names = PyObject_CallMethod(pred, method, nullptr);
  if (!names) {
    set_error_from_python();
    return false;
  }
  PyObject* seq = PySequence_Fast(names, "names not a sequence");
  Py_DECREF(names);
  if (!seq) {
    set_error_from_python();
    return false;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* c = PyUnicode_AsUTF8(PySequence_Fast_GET_ITEM(seq, i));
    if (!c) {
      Py_DECREF(seq);
      set_error_from_python();
      return false;
    }
    out->push_back(c);
  }
  Py_DECREF(seq);
  return true;
}

// np.frombuffer(bytearray, dtype).reshape(handle._shape) handed to
// handle.copy_from_cpu: one copy of the caller's buffer, into a writable
// array that the input tensor may share on the CPU.
int copy_from_cpu(void* tensor, const void* data, size_t nbytes,
                  const char* dtype) {
  GIL gil;
  TensorHandle* t = static_cast<TensorHandle*>(tensor);
  PyObject* buf = PyByteArray_FromStringAndSize(
      static_cast<const char*>(data), static_cast<Py_ssize_t>(nbytes));
  if (!buf) {
    set_error_from_python();
    return -1;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* arr =
      np ? PyObject_CallMethod(np, "frombuffer", "Os", buf, dtype) : nullptr;
  Py_XDECREF(np);
  Py_DECREF(buf);
  if (!arr) {
    set_error_from_python();
    return -1;
  }
  PyObject* shape = PyObject_GetAttrString(t->obj, "_shape");
  if (!shape) {
    Py_DECREF(arr);
    set_error_from_python();
    return -1;
  }
  PyObject* shaped = shape != Py_None
                         ? PyObject_CallMethod(arr, "reshape", "O", shape)
                         : (Py_INCREF(arr), arr);
  Py_DECREF(shape);
  Py_DECREF(arr);
  if (!shaped) {
    set_error_from_python();
    return -1;
  }
  PyObject* r = PyObject_CallMethod(t->obj, "copy_from_cpu", "O", shaped);
  Py_DECREF(shaped);
  if (!r) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

}  // namespace

extern "C" {

int PDT_Init(const char* platform) {
  std::string p(platform ? platform : "");
  for (char c : p) {
    if (!(std::isalnum(static_cast<unsigned char>(c)) || c == '_' ||
          c == '-')) {
      g_last_error = "invalid platform string";
      return -1;
    }
  }
  if (p == "gpu" || p == "cuda") p.clear();
  if (!p.empty() && p != "cpu") {
    g_last_error = "unsupported platform '" + p + "' (\"\" or \"cpu\")";
    return -1;
  }
  g_platform = p;
  return start_interpreter() ? 0 : -1;
}

const char* PDT_GetLastError() { return g_last_error.c_str(); }

void* PDT_ConfigCreate() { return new Config(); }

void PDT_ConfigSetModel(void* config, const char* prog_path) {
  static_cast<Config*>(config)->prog_path = prog_path ? prog_path : "";
}

void PDT_ConfigDestroy(void* config) { delete static_cast<Config*>(config); }

void* PDT_PredictorCreate(void* config) {
  if (!start_interpreter()) return nullptr;
  GIL gil;
  Config* cfg = static_cast<Config*>(config);
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  if (!mod) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* pred = nullptr;
  PyObject* cfg_obj =
      PyObject_CallMethod(mod, "Config", "s", cfg->prog_path.c_str());
  if (cfg_obj) {
    PyObject* ok = g_platform == "cpu"
                       ? PyObject_CallMethod(cfg_obj, "disable_gpu", nullptr)
                       : (Py_INCREF(Py_None), Py_None);
    if (ok) {
      Py_DECREF(ok);
      pred = PyObject_CallMethod(mod, "create_predictor", "O", cfg_obj);
    }
    Py_DECREF(cfg_obj);
  }
  Py_DECREF(mod);
  if (!pred) {
    set_error_from_python();
    return nullptr;
  }
  Predictor* p = new Predictor();
  p->obj = pred;
  if (!fetch_names(pred, "get_input_names", &p->input_names) ||
      !fetch_names(pred, "get_output_names", &p->output_names)) {
    Py_DECREF(pred);
    delete p;
    return nullptr;
  }
  return p;
}

void PDT_PredictorDestroy(void* predictor) {
  Predictor* p = static_cast<Predictor*>(predictor);
  if (p) {
    GIL gil;
    Py_XDECREF(p->obj);
    delete p;
  }
}

size_t PDT_PredictorGetInputNum(void* predictor) {
  return static_cast<Predictor*>(predictor)->input_names.size();
}

size_t PDT_PredictorGetOutputNum(void* predictor) {
  return static_cast<Predictor*>(predictor)->output_names.size();
}

const char* PDT_PredictorGetInputName(void* predictor, size_t i) {
  Predictor* p = static_cast<Predictor*>(predictor);
  return i < p->input_names.size() ? p->input_names[i].c_str() : nullptr;
}

const char* PDT_PredictorGetOutputName(void* predictor, size_t i) {
  Predictor* p = static_cast<Predictor*>(predictor);
  return i < p->output_names.size() ? p->output_names[i].c_str() : nullptr;
}

static void* get_handle(void* predictor, const char* name,
                        const char* method) {
  GIL gil;
  Predictor* p = static_cast<Predictor*>(predictor);
  PyObject* h = PyObject_CallMethod(p->obj, method, "s", name);
  if (!h) {
    set_error_from_python();
    return nullptr;
  }
  TensorHandle* t = new TensorHandle();
  t->obj = h;
  return t;
}

void* PDT_PredictorGetInputHandle(void* predictor, const char* name) {
  return get_handle(predictor, name, "get_input_handle");
}

void* PDT_PredictorGetOutputHandle(void* predictor, const char* name) {
  return get_handle(predictor, name, "get_output_handle");
}

void PDT_TensorDestroy(void* tensor) {
  TensorHandle* t = static_cast<TensorHandle*>(tensor);
  if (t) {
    GIL gil;
    Py_XDECREF(t->obj);
    delete t;
  }
}

int PDT_TensorReshape(void* tensor, const int* dims, int ndims) {
  GIL gil;
  TensorHandle* t = static_cast<TensorHandle*>(tensor);
  PyObject* shape = PyList_New(ndims);
  if (!shape) {
    set_error_from_python();
    return -1;
  }
  for (int i = 0; i < ndims; ++i)
    PyList_SET_ITEM(shape, i, PyLong_FromLong(dims[i]));
  PyObject* r = PyObject_CallMethod(t->obj, "reshape", "O", shape);
  Py_DECREF(shape);
  if (!r) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int PDT_TensorCopyFromCpuFloat(void* tensor, const float* data, size_t n) {
  return copy_from_cpu(tensor, data, n * sizeof(float), "float32");
}

int PDT_TensorCopyFromCpuInt64(void* tensor, const int64_t* data, size_t n) {
  return copy_from_cpu(tensor, data, n * sizeof(int64_t), "int64");
}

int PDT_PredictorRun(void* predictor) {
  GIL gil;
  Predictor* p = static_cast<Predictor*>(predictor);
  PyObject* r = PyObject_CallMethod(p->obj, "run", nullptr);
  if (!r) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int PDT_TensorGetShape(void* tensor, int* dims_out, int max_dims,
                       int* ndims_out) {
  GIL gil;
  TensorHandle* t = static_cast<TensorHandle*>(tensor);
  PyObject* shape = PyObject_CallMethod(t->obj, "shape", nullptr);
  if (!shape) {
    set_error_from_python();
    return -1;
  }
  PyObject* seq = PySequence_Fast(shape, "shape not a sequence");
  Py_DECREF(shape);
  if (!seq) {
    set_error_from_python();
    return -1;
  }
  int n = static_cast<int>(PySequence_Fast_GET_SIZE(seq));
  *ndims_out = n;
  for (int i = 0; i < n && i < max_dims; ++i)
    dims_out[i] =
        static_cast<int>(PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i)));
  Py_DECREF(seq);
  return 0;
}

// The output as float32 (bfloat16 and float16 widen exactly), copied into
// data; at most n values.
int PDT_TensorCopyToCpuFloat(void* tensor, float* data, size_t n) {
  GIL gil;
  TensorHandle* t = static_cast<TensorHandle*>(tensor);
  PyObject* arr = PyObject_CallMethod(t->obj, "copy_to_cpu", nullptr);
  if (!arr) {
    set_error_from_python();
    return -1;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* flat = np ? PyObject_CallMethod(np, "ascontiguousarray", "Os",
                                            arr, "float32")
                      : nullptr;
  Py_XDECREF(np);
  Py_DECREF(arr);
  if (!flat) {
    set_error_from_python();
    return -1;
  }
  PyObject* bytes = PyObject_CallMethod(flat, "tobytes", nullptr);
  Py_DECREF(flat);
  if (!bytes) {
    set_error_from_python();
    return -1;
  }
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(bytes, &buf, &len) != 0) {
    Py_DECREF(bytes);
    set_error_from_python();
    return -1;
  }
  size_t want = n * sizeof(float);
  std::memcpy(data, buf,
              static_cast<size_t>(len) < want ? static_cast<size_t>(len)
                                              : want);
  Py_DECREF(bytes);
  return 0;
}

}  // extern "C"
