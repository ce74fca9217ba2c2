/* One C driver of the C API, linked once against each library: the port's
 * (flexflow_tpu_torch/native/flexflow_c.cpp) and the first one
 * (native/flexflow_c.cpp).  Never load both into one process: each embeds
 * an interpreter.
 *
 *   capi_parity JOB [+ JOB ...]
 *   JOB = MODEL OUTDIR [key=value ...]
 *     MODEL    mlp (16 -> dense 32 relu -> dense 4 -> softmax),
 *              cnn (3x8x8 -> conv 8 3x3 relu -> max pool 2 -> flat ->
 *              dense 10 -> softmax), alexnet (the reference's, 3x229x229)
 *              or loader (test_capi.c's dataloader section, below)
 *     opt=sgd|adam  lr=X (0.01; adam alpha)  steps=N (3)  batch=B (8)
 *     in=DIR       x.bin (the batch, float32, (N, C, H, W) for images),
 *                  y.bin (int32 labels) and <op>.<weight>.bin (float32,
 *                  in get_parameter's layout) for each weight it holds
 *     args="..."   flags for flexflow_config_parse_args (--bf16 ...)
 *     timed=N      N more steps after the dump, timed (ms a step)
 *     pre=FILE     Python run in the library's interpreter before the
 *                  job (test settings: TF32 off, cuDNN deterministic)
 *     launches=1   the port's kernel launch counters before the steps,
 *                  after each of them and after the timed ones (never
 *                  inside the timed window); the captured step's graph
 *                  (captures, replays, kernel nodes), each live model's
 *                  device and the file flexflow_tpu_torch was imported
 *                  from, into OUTDIR/launches.json
 *
 * Each job builds its model through the C API, sets the weights in IN,
 * stages the batch once, takes `steps` steps (flexflow_model_train_
 * iteration), then writes every parameter to OUTDIR/<op>.<weight>.bin and
 * its metrics to OUTDIR/metrics.txt.  `pre` and `launches` reach into the
 * interpreter with PyRun_SimpleString: test code, not the C API.
 *
 * The loader job drives what the others do not: (batch, 8) -> dense_v2 32
 * relu "fc1" (glorot and zero initializer objects) -> a deferred dense 4
 * "fc2" (dense_no_inout, op_init_inout, op_add_to_model) -> softmax; an
 * optimizer object (SGD, no momentum, or Adam) made at lr/10, set_lr to
 * lr, bound before compile with the optimizer ""; the weights in IN set
 * through the layers' parameter handles (parameter_set_weights_float).
 * IN holds xs.bin (4 * batch samples of 8 float32) and ys.bin (their
 * int32 labels).  `steps` steps each staged by a 2-D dataloader over them
 * (from the start again at their end), inside begin/end_trace; then one
 * step staged by two single dataloaders, the input's over xs attached to
 * the input tensor (attach_raw_ptr), which inline_map must read back.
 */

#include "flexflow_c.h"

#include <Python.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAX_W 32

typedef struct {
  const char* model;
  const char* out;
  const char* opt;
  const char* in;
  const char* args;
  const char* pre;
  double lr;
  int steps, batch, timed, launches;
} Job;

typedef struct {
  const char* op;
  const char* w;
} Weight;

static int n_weights = 0;
static Weight weights[MAX_W];
/* every tensor handle a job made: a handle holds its model, so each is
   destroyed at the job's end */
static int n_tensors = 0;
static flexflow_tensor_t tensors[64];

static void fail(const char* what) {
  fprintf(stderr, "capi_parity: %s failed\n", what);
  exit(1);
}

static void need(int ok, const char* what) {
  if (!ok) fail(what);
}

static flexflow_tensor_t kept(flexflow_tensor_t t, const char* what) {
  need(t.impl != NULL && n_tensors < 64, what);
  tensors[n_tensors++] = t;
  return t;
}

static void add_weights(const char* op, int bias) {
  weights[n_weights].op = op;
  weights[n_weights++].w = "kernel";
  if (bias) {
    weights[n_weights].op = op;
    weights[n_weights++].w = "bias";
  }
}

static flexflow_tensor_t conv(flexflow_model_t m, flexflow_tensor_t t,
                              const char* name, int oc, int k, int s, int p) {
  add_weights(name, 1);
  return kept(flexflow_model_add_conv2d(m, t, oc, k, k, s, s, p, p, 1, 1, name),
              name);
}

static flexflow_tensor_t pool(flexflow_model_t m, flexflow_tensor_t t,
                              const char* name, int k, int s) {
  return kept(flexflow_model_add_pool2d(m, t, k, k, s, s, 0, 0, 1, name), name);
}

static flexflow_tensor_t dense(flexflow_model_t m, flexflow_tensor_t t,
                               const char* name, int out, int relu) {
  add_weights(name, 1);
  return kept(flexflow_model_add_dense(m, t, out, relu, 1, name), name);
}

/* The job's graph; returns its input tensor, and the input's volume. */
static flexflow_tensor_t build(flexflow_model_t m, const Job* j,
                               int64_t* in_count) {
  flexflow_tensor_t in, t;
  n_weights = 0;
  n_tensors = 0;
  if (strcmp(j->model, "mlp") == 0) {
    int dims[2] = {j->batch, 16};
    in = kept(flexflow_tensor_create(m, 2, dims, "float32"), "the input");
    *in_count = (int64_t)j->batch * 16;
    t = dense(m, in, "fc1", 32, 1);
    t = dense(m, t, "fc2", 4, 0);
  } else {
    int s = strcmp(j->model, "alexnet") == 0 ? 229 : 8; /* the image side */
    int dims[4] = {j->batch, 3, s, s};
    in = kept(flexflow_tensor_create(m, 4, dims, "float32"), "the input");
    *in_count = (int64_t)j->batch * 3 * s * s;
    if (strcmp(j->model, "cnn") == 0) {
      t = conv(m, in, "conv1", 8, 3, 1, 1);
      t = pool(m, t, "pool1", 2, 2);
      t = kept(flexflow_model_add_flat(m, t, "flat1"), "flat1");
      t = dense(m, t, "fc1", 10, 0);
    } else if (strcmp(j->model, "alexnet") == 0) {
      /* reference: examples/cpp/AlexNet/alexnet.cc:54-80 */
      t = conv(m, in, "conv1", 64, 11, 4, 2);
      t = pool(m, t, "pool1", 3, 2);
      t = conv(m, t, "conv2", 192, 5, 1, 2);
      t = pool(m, t, "pool2", 3, 2);
      t = conv(m, t, "conv3", 384, 3, 1, 1);
      t = conv(m, t, "conv4", 256, 3, 1, 1);
      t = conv(m, t, "conv5", 256, 3, 1, 1);
      t = pool(m, t, "pool3", 3, 2);
      t = kept(flexflow_model_add_flat(m, t, "flat"), "flat");
      t = dense(m, t, "fc1", 4096, 1);
      t = dense(m, t, "fc2", 4096, 1);
      t = dense(m, t, "fc3", 10, 0);
    } else {
      fail("an unknown model");
    }
  }
  kept(flexflow_model_add_softmax(m, t, "softmax"), "softmax");
  return in;
}

/* `count` values of `size` bytes from DIR/NAME; 0 when there is no file. */
static int read_file(const char* dir, const char* name, void* buf,
                     size_t size, int64_t count) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  size_t got = fread(buf, size, (size_t)count, f);
  fclose(f);
  if (got != (size_t)count) {
    fprintf(stderr, "capi_parity: %s holds %zu values, not %lld\n", path, got,
            (long long)count);
    exit(1);
  }
  return 1;
}

static void write_file(const char* dir, const char* name, const void* buf,
                       size_t bytes) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "wb");
  need(f != NULL && fwrite(buf, 1, bytes, f) == bytes, path);
  fclose(f);
}

/* Python in the library's interpreter, under its lock (test code). */
static void py(const char* code) {
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = PyRun_SimpleString(code);
  PyGILState_Release(st);
  need(rc == 0, "a test hook");
}

static const char* kLaunchHooks =
    "import gc, json\n"
    "import flexflow_tpu_torch as _ffp_pkg\n"
    "from flexflow_tpu_torch.kernels import fused_optimizer as _ffp_fo\n"
    "from flexflow_tpu_torch.runtime.step_graph import StepGraph as _ffp_sg\n"
    "_ffp_sg.record_kernels = True\n"
    "_ffp_snaps = []\n"
    "def _ffp_snap():\n"
    "    _ffp_snaps.append({'fused_sgd_update': _ffp_fo.fused_sgd_update.launches,\n"
    "                       'fused_adam_update': _ffp_fo.fused_adam_update.launches})\n"
    "def _ffp_dump(path):\n"
    "    from flexflow_tpu_torch.model import FFModel\n"
    "    gc.collect()  # the models of the jobs before\n"
    "    live = gc.get_objects()\n"
    "    graphs = [{'captures': g.captures, 'replays': g.replays,\n"
    "               'kernel_names': g.kernel_names}\n"
    "              for g in live if isinstance(g, _ffp_sg)]\n"
    "    devices = [str(m.device) for m in live if isinstance(m, FFModel)]\n"
    "    json.dump({'snaps': _ffp_snaps, 'graphs': graphs, 'devices': devices,\n"
    "               'package': _ffp_pkg.__file__}, open(path, 'w'))\n"
    "    _ffp_sg.record_kernels = False\n"
    "_ffp_snap()\n";

/* Sync, write every parameter and the metrics, take the timed steps (their
   launch snapshot after the window), destroy the job's handles. */
static void finish_job(const Job* j, flexflow_model_t m, flexflow_config_t cfg) {
  char code[8192], name[256];
  need(flexflow_model_sync(m) == 0, "sync");
  for (int i = 0; i < n_weights; i++) {
    int64_t n = flexflow_parameter_get_volume(m, weights[i].op, weights[i].w);
    float* w = (float*)malloc(sizeof(float) * (size_t)n);
    need(flexflow_model_get_parameter_f32(m, weights[i].op, weights[i].w, w,
                                          n) == 0,
         "get_parameter_f32");
    snprintf(name, sizeof name, "%s.%s.bin", weights[i].op, weights[i].w);
    write_file(j->out, name, w, sizeof(float) * (size_t)n);
    free(w);
  }
  int64_t all = 0, correct = 0;
  double acc = flexflow_model_get_accuracy(m, &all, &correct);
  double loss = flexflow_model_get_metric(m, "sparse_cce_loss");
  double ms = 0.0;
  if (j->timed > 0) {
    double t0 = flexflow_get_current_time(m);
    for (int s = 0; s < j->timed; s++)
      need(flexflow_model_train_iteration(m) == 0, "train_iteration");
    need(flexflow_model_sync(m) == 0, "sync");
    ms = (flexflow_get_current_time(m) - t0) / 1e3 / j->timed;
    if (j->launches) py("_ffp_snap()");
  }
  if (j->launches) {
    snprintf(code, sizeof code, "_ffp_dump(r'%s/launches.json')", j->out);
    py(code);
  }
  char text[512];
  int len = snprintf(text, sizeof text,
                     "accuracy %.17g\ntrain_all %lld\ntrain_correct %lld\n"
                     "sparse_cce_loss %.17g\nms_per_step %.6f\n",
                     acc, (long long)all, (long long)correct, loss, ms);
  write_file(j->out, "metrics.txt", text, (size_t)len);
  printf("capi_parity: %s %s %d steps: accuracy %.2f%% (%lld/%lld), "
         "sparse_cce_loss %.6f, %.3f ms/step over %d timed steps\n",
         j->model, j->opt, j->steps, acc, (long long)correct, (long long)all,
         loss, ms, j->timed);
  fflush(stdout);
  for (int i = 0; i < n_tensors; i++) flexflow_tensor_destroy(tensors[i]);
  flexflow_model_destroy(m);
  flexflow_config_destroy(cfg);
}

static void run_job(const Job* j) {
  char code[8192], name[256];
  if (j->pre) {
    snprintf(code, sizeof code, "exec(open(r'%s').read())", j->pre);
    py(code);
  }
  flexflow_config_t cfg = flexflow_config_create(j->batch, 1, 0);
  need(cfg.impl != NULL, "flexflow_config_create");
  if (j->args) { /* split on spaces */
    char buf[1024];
    char* argv[64];
    int argc = 0;
    snprintf(buf, sizeof buf, "%s", j->args);
    for (char* tok = strtok(buf, " "); tok && argc < 64; tok = strtok(NULL, " "))
      argv[argc++] = tok;
    need(flexflow_config_parse_args(cfg, argc, argv) == 0, "parse_args");
  }
  flexflow_model_t m = flexflow_model_create(cfg);
  need(m.impl != NULL, "flexflow_model_create");
  int64_t in_count = 0;
  flexflow_tensor_t in = build(m, j, &in_count);
  const char* metrics[] = {"accuracy", "sparse_categorical_crossentropy"};
  need(flexflow_model_compile(m, j->opt, j->lr,
                              "sparse_categorical_crossentropy", metrics,
                              2) == 0,
       "compile");
  need(flexflow_model_init_layers(m) == 0, "init_layers");
  for (int i = 0; j->in && i < n_weights; i++) {
    int64_t n = flexflow_parameter_get_volume(m, weights[i].op, weights[i].w);
    need(n > 0, "get_volume");
    float* w = (float*)malloc(sizeof(float) * (size_t)n);
    snprintf(name, sizeof name, "%s.%s.bin", weights[i].op, weights[i].w);
    if (read_file(j->in, name, w, sizeof(float), n))
      need(flexflow_model_set_parameter_f32(m, weights[i].op, weights[i].w,
                                            w, n) == 0,
           "set_parameter_f32");
    free(w);
  }
  float* x = (float*)malloc(sizeof(float) * (size_t)in_count);
  int32_t* y = (int32_t*)malloc(sizeof(int32_t) * (size_t)j->batch);
  need(j->in && read_file(j->in, "x.bin", x, sizeof(float), in_count) &&
           read_file(j->in, "y.bin", y, sizeof(int32_t), j->batch),
       "reading the batch (in=DIR with x.bin and y.bin)");
  need(flexflow_model_set_input_f32(m, in, x, in_count) == 0, "set_input");
  need(flexflow_model_set_label_i32(m, y, j->batch) == 0, "set_label");
  free(x);
  free(y);
  if (j->launches) py(kLaunchHooks);
  for (int s = 0; s < j->steps; s++) {
    need(flexflow_model_train_iteration(m) == 0, "train_iteration");
    if (j->launches) py("_ffp_snap()");
  }
  finish_job(j, m, cfg);
}

/* The loader job (see the top of this file). */
static void run_loader_job(const Job* j) {
  enum { FEAT = 8, HIDDEN = 32, CLASSES = 4 };
  const int B = j->batch, NS = 4 * j->batch;
  char name[256];
  n_weights = 0;
  n_tensors = 0;
  need(j->in != NULL, "the loader job's in=DIR");
  flexflow_config_t cfg = flexflow_config_create(B, 1, 0);
  need(cfg.impl != NULL, "flexflow_config_create");
  flexflow_model_t m = flexflow_model_create(cfg);
  need(m.impl != NULL, "flexflow_model_create");
  int dims[2] = {B, FEAT};
  flexflow_tensor_t in = kept(flexflow_tensor_create(m, 2, dims, "float32"), "the input");
  flexflow_glorot_uniform_initializer_t gi = flexflow_glorot_uniform_initializer_create(3);
  flexflow_zero_initializer_t zi = flexflow_zero_initializer_create();
  need(gi.impl != NULL && zi.impl != NULL, "the initializer objects");
  flexflow_initializer_t ki = {gi.impl}, bi = {zi.impl};
  add_weights("fc1", 1);
  flexflow_tensor_t t = kept(flexflow_model_add_dense_v2(m, in, HIDDEN, 1, 1, ki, bi, "fc1"),
                             "dense_v2");
  add_weights("fc2", 1);
  flexflow_op_t fc2 = flexflow_model_add_dense_no_inout(m, CLASSES, 0, 1, "fc2");
  need(fc2.impl != NULL, "dense_no_inout");
  t = kept(flexflow_op_init_inout(fc2, m, t), "op_init_inout");
  need(flexflow_op_add_to_model(fc2, m) == 0, "op_add_to_model");
  kept(flexflow_model_add_softmax(m, t, "softmax"), "softmax");
  flexflow_sgd_optimizer_t sgd = {NULL};
  flexflow_adam_optimizer_t adam = {NULL};
  if (strcmp(j->opt, "sgd") == 0) {
    sgd = flexflow_sgd_optimizer_create(m, j->lr / 10, 0.0, 0, 0.0);
    flexflow_sgd_optimizer_set_lr(sgd, j->lr);
    need(flexflow_model_set_sgd_optimizer(m, sgd) == 0, "set_sgd_optimizer");
  } else {
    adam = flexflow_adam_optimizer_create(m, j->lr / 10, 0.9, 0.999, 0.0, 1e-8);
    flexflow_adam_optimizer_set_lr(adam, j->lr);
    need(flexflow_model_set_adam_optimizer(m, adam) == 0, "set_adam_optimizer");
  }
  const char* metrics[] = {"accuracy", "sparse_categorical_crossentropy"};
  need(flexflow_model_compile(m, "", 0.0, "sparse_categorical_crossentropy", metrics, 2) == 0,
       "compile");
  need(flexflow_model_init_layers(m) == 0, "init_layers");
  for (int i = 0; i < n_weights; i++) { /* layer i / 2, its weight i % 2 */
    flexflow_op_t layer = flexflow_model_get_layer_by_id(m, i / 2);
    flexflow_parameter_t p = flexflow_op_get_parameter_by_id(layer, i % 2);
    need(layer.impl != NULL && p.impl != NULL, "a parameter handle");
    int64_t n = flexflow_parameter_get_volume_v2(p);
    need(n > 0, "get_volume_v2");
    float* w = (float*)malloc(sizeof(float) * (size_t)n);
    float* back = (float*)malloc(sizeof(float) * (size_t)n);
    snprintf(name, sizeof name, "%s.%s.bin", weights[i].op, weights[i].w);
    need(read_file(j->in, name, w, sizeof(float), n), name);
    need(flexflow_parameter_set_weights_float(p, w, n) == 0, "parameter_set_weights_float");
    need(flexflow_model_get_parameter_f32(m, weights[i].op, weights[i].w, back, n) == 0 &&
             memcmp(w, back, sizeof(float) * (size_t)n) == 0,
         "the weight set through its handle, read back by name");
    free(w);
    free(back);
    flexflow_parameter_destroy(p);
    flexflow_op_destroy(layer);
  }
  float* xs = (float*)malloc(sizeof(float) * (size_t)NS * FEAT);
  int32_t* ys = (int32_t*)malloc(sizeof(int32_t) * (size_t)NS);
  need(read_file(j->in, "xs.bin", xs, sizeof(float), (int64_t)NS * FEAT) &&
           read_file(j->in, "ys.bin", ys, sizeof(int32_t), NS),
       "reading the dataset (xs.bin and ys.bin)");
  flexflow_dataloader_2d_t dl = flexflow_dataloader_2d_create(m, in, xs, ys, NS);
  need(dl.impl != NULL && flexflow_dataloader_2d_get_num_samples(dl) == NS,
       "dataloader_2d_create");
  flexflow_dataloader_2d_reset(dl);
  flexflow_begin_trace(m, 111);
  for (int s = 0; s < j->steps; s++) {
    need(flexflow_dataloader_2d_next_batch(dl, m) == 0, "dataloader_2d_next_batch");
    need(flexflow_model_train_iteration(m) == 0, "train_iteration");
  }
  flexflow_end_trace(m, 111);
  flexflow_dataloader_2d_destroy(dl);
  /* one step more from the single dataloaders, the input's over memory
     attached to the input tensor */
  need(flexflow_tensor_attach_raw_ptr(m, in, xs, (int64_t)NS * FEAT, 1) == 0, "attach_raw_ptr");
  flexflow_single_dataloader_t sx = flexflow_single_dataloader_create(m, in, NULL, NS, 1, 0);
  flexflow_tensor_t label = kept(flexflow_model_get_label_tensor(m), "the label tensor");
  flexflow_single_dataloader_t sy = flexflow_single_dataloader_create(m, label, ys, NS, 0, 1);
  need(sx.impl != NULL && sy.impl != NULL, "single_dataloader_create");
  need(flexflow_single_dataloader_next_batch(sx, m) == 0 &&
           flexflow_single_dataloader_next_batch(sy, m) == 0,
       "single_dataloader_next_batch");
  need(flexflow_model_train_iteration(m) == 0, "train_iteration");
  need(flexflow_tensor_inline_map(m, in) == 0, "inline_map");
  float* raw = flexflow_tensor_get_raw_ptr_float(m, in);
  need(raw != NULL && memcmp(raw, xs, sizeof(float) * (size_t)NS * FEAT) == 0,
       "the mapped input equal to the attached memory");
  flexflow_tensor_inline_unmap(m, in);
  need(flexflow_tensor_detach_raw_ptr(m, in) == 0, "detach_raw_ptr");
  flexflow_single_dataloader_destroy(sx);
  flexflow_single_dataloader_destroy(sy);
  if (sgd.impl) flexflow_sgd_optimizer_destroy(sgd);
  if (adam.impl) flexflow_adam_optimizer_destroy(adam);
  flexflow_glorot_uniform_initializer_destroy(gi);
  flexflow_zero_initializer_destroy(zi);
  flexflow_op_destroy(fc2);
  finish_job(j, m, cfg);
  /* freed only now: the first library stages attached memory without a
     copy, and its step may read it until the model is synchronized */
  free(xs);
  free(ys);
}

int main(int argc, char** argv) {
  need(flexflow_init() == 0, "flexflow_init");
  int i = 1;
  while (i < argc) {
    need(i + 1 < argc, "a job needs MODEL OUTDIR");
    Job j = {argv[i], argv[i + 1], "sgd", NULL, NULL, NULL, 0.01, 3, 8, 0, 0};
    for (i += 2; i < argc && strcmp(argv[i], "+") != 0; i++) {
      const char* a = argv[i];
      const char* v = strchr(a, '=');
      need(v != NULL, a);
      v++;
      if (strncmp(a, "opt=", 4) == 0) j.opt = v;
      else if (strncmp(a, "lr=", 3) == 0) j.lr = atof(v);
      else if (strncmp(a, "steps=", 6) == 0) j.steps = atoi(v);
      else if (strncmp(a, "batch=", 6) == 0) j.batch = atoi(v);
      else if (strncmp(a, "in=", 3) == 0) j.in = v;
      else if (strncmp(a, "args=", 5) == 0) j.args = v;
      else if (strncmp(a, "timed=", 6) == 0) j.timed = atoi(v);
      else if (strncmp(a, "pre=", 4) == 0) j.pre = v;
      else if (strncmp(a, "launches=", 9) == 0) j.launches = atoi(v);
      else fail(a);
    }
    if (i < argc) i++; /* the "+" */
    if (strcmp(j.model, "loader") == 0)
      run_loader_job(&j);
    else
      run_job(&j);
  }
  printf("capi_parity: OK\n");
  return 0;
}
