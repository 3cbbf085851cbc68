/* A C program serving jit.saved models of paddle_tpu_torch through the
 * port's serving C ABI (libpt_capi.so, paddle_tpu_torch/csrc/
 * predictor_capi.cc): dlopen, PDT_Init, then for each model a Predictor,
 * and for each of its input shapes that input fed from a raw file and
 * `reps` runs, the first output written raw.
 *
 *   torch_capi_smoke <reps> <input.bin> <output.bin>
 *                    <model_prefix> <f32|i64> <shape> [<shape> ...]
 *                    [-- <model_prefix> <f32|i64> <shape> ...] ...
 *
 * A shape is its dims joined by 'x' (64x3x224x224). input.bin holds each
 * (model, shape)'s values in turn (float32 or int64, C order); output.bin
 * receives each one's first output in turn, as float32, after its last
 * run. Each run is a copy in, PDT_PredictorRun and a copy out (which
 * waits for the device). Prints "STARTUP_S <s>" (main() to the first
 * Predictor made: the interpreter, torch and that model's load), for
 * each model "MODEL <prefix> <load s>" and "IO <input> -> <output>", and
 * for each shape "RUN_MS <shape> <ms> ..." and "SHAPE <shape> <d0> ...".
 * PDT_PLATFORM ("" or unset: the card; "cpu") goes to PDT_Init. Build:
 *   gcc -O1 tests/torch_capi_smoke.c -o torch_capi_smoke -ldl
 * and run with LD_LIBRARY_PATH on build/paddle_tpu_torch and PYTHONPATH
 * on the repo root (PDT_PYTHON may name the Python to embed). Exit 1 on
 * an ABI error (its PDT_GetLastError on stderr), 2 on a usage or file
 * error. */
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

typedef void* (*fp_void)(void);
typedef void (*fp_cfg_set)(void*, const char*);
typedef void* (*fp_pred_create)(void*);
typedef size_t (*fp_num)(void*);
typedef const char* (*fp_name)(void*, size_t);
typedef void* (*fp_handle)(void*, const char*);
typedef int (*fp_reshape)(void*, const int*, int);
typedef int (*fp_copy_f32)(void*, const float*, size_t);
typedef int (*fp_copy_i64)(void*, const int64_t*, size_t);
typedef int (*fp_run)(void*);
typedef int (*fp_get_shape)(void*, int*, int, int*);
typedef int (*fp_copy_to)(void*, float*, size_t);
typedef void (*fp_destroy)(void*);
typedef int (*fp_init)(const char*);
typedef const char* (*fp_err)(void);

#define LOAD(sym, type)                           \
  type sym = (type)dlsym(lib, #sym);              \
  if (!sym) {                                     \
    fprintf(stderr, "missing symbol %s\n", #sym); \
    return 2;                                     \
  }

#define ABI(call, what)                                       \
  if ((call) != 0) {                                          \
    fprintf(stderr, "%s: %s\n", what, PDT_GetLastError());    \
    return 1;                                                 \
  }

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

static int parse_shape(const char* text, int* dims, size_t* count) {
  int n = 0;
  *count = 1;
  const char* p = text;
  while (*p && n < 8) {
    char* end = NULL;
    long d = strtol(p, &end, 10);
    if (end == p || d <= 0) return -1;
    dims[n++] = (int)d;
    *count *= (size_t)d;
    p = *end == 'x' ? end + 1 : end;
  }
  return *p ? -1 : n;
}

int main(int argc, char** argv) {
  double t_start = now_s();
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s <reps> <input.bin> <output.bin> <model_prefix> "
            "<f32|i64> <shape> [<shape> ...] [-- <model_prefix> ...]\n",
            argv[0]);
    return 2;
  }
  int reps = atoi(argv[1]);
  FILE* fin = fopen(argv[2], "rb");
  FILE* fout = fopen(argv[3], "wb");
  if (reps < 1 || !fin || !fout) {
    fprintf(stderr, "need reps >= 1, a readable %s and a writable %s\n",
            argv[2], argv[3]);
    return 2;
  }

  void* lib = dlopen("libpt_capi.so", RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    fprintf(stderr, "dlopen: %s\n", dlerror());
    return 2;
  }
  LOAD(PDT_Init, fp_init);
  LOAD(PDT_GetLastError, fp_err);
  LOAD(PDT_ConfigCreate, fp_void);
  LOAD(PDT_ConfigSetModel, fp_cfg_set);
  LOAD(PDT_ConfigDestroy, fp_destroy);
  LOAD(PDT_PredictorCreate, fp_pred_create);
  LOAD(PDT_PredictorDestroy, fp_destroy);
  LOAD(PDT_PredictorGetInputNum, fp_num);
  LOAD(PDT_PredictorGetInputName, fp_name);
  LOAD(PDT_PredictorGetOutputNum, fp_num);
  LOAD(PDT_PredictorGetOutputName, fp_name);
  LOAD(PDT_PredictorGetInputHandle, fp_handle);
  LOAD(PDT_PredictorGetOutputHandle, fp_handle);
  LOAD(PDT_TensorReshape, fp_reshape);
  LOAD(PDT_TensorCopyFromCpuFloat, fp_copy_f32);
  LOAD(PDT_TensorCopyFromCpuInt64, fp_copy_i64);
  LOAD(PDT_PredictorRun, fp_run);
  LOAD(PDT_TensorGetShape, fp_get_shape);
  LOAD(PDT_TensorCopyToCpuFloat, fp_copy_to);
  LOAD(PDT_TensorDestroy, fp_destroy);

  const char* platform = getenv("PDT_PLATFORM");
  ABI(PDT_Init(platform ? platform : ""), "init");
  int first = 1;
  int a = 4;
  while (a < argc) {
    if (a + 2 >= argc) {
      fprintf(stderr, "a model needs a kind and at least one shape\n");
      return 2;
    }
    const char* model = argv[a];
    int is_i64 = strcmp(argv[a + 1], "i64") == 0;
    size_t esize = is_i64 ? sizeof(int64_t) : sizeof(float);
    a += 2;
    double t0 = now_s();
    void* cfg = PDT_ConfigCreate();
    PDT_ConfigSetModel(cfg, model);
    void* pred = PDT_PredictorCreate(cfg);
    PDT_ConfigDestroy(cfg);
    if (!pred) {
      fprintf(stderr, "create: %s\n", PDT_GetLastError());
      return 1;
    }
    if (PDT_PredictorGetInputNum(pred) < 1 ||
        PDT_PredictorGetOutputNum(pred) < 1) {
      fprintf(stderr, "io counts: %zu in %zu out\n",
              PDT_PredictorGetInputNum(pred),
              PDT_PredictorGetOutputNum(pred));
      return 1;
    }
    if (first) printf("STARTUP_S %.6f\n", now_s() - t_start);
    first = 0;
    printf("MODEL %s %.6f\n", model, now_s() - t0);
    const char* in_name = PDT_PredictorGetInputName(pred, 0);
    const char* out_name = PDT_PredictorGetOutputName(pred, 0);
    printf("IO %s -> %s\n", in_name, out_name);
    void* in = PDT_PredictorGetInputHandle(pred, in_name);
    if (!in) {
      fprintf(stderr, "input handle: %s\n", PDT_GetLastError());
      return 1;
    }
    for (; a < argc && strcmp(argv[a], "--") != 0; ++a) {
      const char* shape = argv[a];
      int dims[8];
      size_t count = 0;
      int ndims = parse_shape(shape, dims, &count);
      if (ndims < 1) {
        fprintf(stderr, "bad shape %s (at most 8 dims joined by x)\n",
                shape);
        return 2;
      }
      void* data = malloc(count * esize);
      if (!data || fread(data, esize, count, fin) != count) {
        fprintf(stderr, "cannot read %zu values from %s\n", count, argv[2]);
        return 2;
      }
      float* result = NULL;
      size_t total = 0;
      int oshape[8], ondims = 0;
      printf("RUN_MS %s", shape);
      for (int r = 0; r < reps; ++r) {
        double t1 = now_s();
        ABI(PDT_TensorReshape(in, dims, ndims), "reshape");
        if (is_i64) {
          ABI(PDT_TensorCopyFromCpuInt64(in, (const int64_t*)data, count),
              "copy_from");
        } else {
          ABI(PDT_TensorCopyFromCpuFloat(in, (const float*)data, count),
              "copy_from");
        }
        ABI(PDT_PredictorRun(pred), "run");
        void* out = PDT_PredictorGetOutputHandle(pred, out_name);
        if (!out) {
          fprintf(stderr, "output handle: %s\n", PDT_GetLastError());
          return 1;
        }
        ABI(PDT_TensorGetShape(out, oshape, 8, &ondims), "get_shape");
        total = 1;
        for (int i = 0; i < ondims && i < 8; ++i) total *= (size_t)oshape[i];
        if (!result) result = (float*)malloc(sizeof(float) * total);
        ABI(PDT_TensorCopyToCpuFloat(out, result, total), "copy_to");
        PDT_TensorDestroy(out);
        printf(" %.4f", 1e3 * (now_s() - t1));
        fflush(stdout);
      }
      printf("\nSHAPE %s", shape);
      for (int i = 0; i < ondims; ++i) printf(" %d", oshape[i]);
      printf("\n");
      if (fwrite(result, sizeof(float), total, fout) != total) {
        fprintf(stderr, "cannot write %s\n", argv[3]);
        return 2;
      }
      free(result);
      free(data);
    }
    a += 1;  /* past "--" */
    PDT_TensorDestroy(in);
    PDT_PredictorDestroy(pred);
  }
  fclose(fin);
  fclose(fout);
  return 0;
}
