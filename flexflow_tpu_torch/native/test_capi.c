/* C API smoke test of the port's library (flexflow_tpu_torch/native/
 * flexflow_c.cpp) — analogue of the reference's C-API smoke tests
 * (reference: tests/alexnet_c/alexnet.cc:16-30) and the counterpart of
 * native/test_capi.c.  Builds an MLP via the C surface, trains a few steps
 * on a learnable synthetic task, asserts the accuracy climbs above chance,
 * then drives the rest of the surface.  Runs on the GPU, or on the CPU
 * with FLEXFLOW_TORCH_DEVICE=cpu; files go under $TMPDIR (else /tmp).
 *
 *   python -m flexflow_tpu_torch.native.capi     # the library, the link flags
 *   gcc -Iflexflow_tpu_torch/native test_capi.c <link flags> -o test_capi
 */

#include "flexflow_c.h"

#include <assert.h>
#include <stdio.h>
#include <stdlib.h>

static const char* tmp_path(char* buf, size_t n, const char* name) {
  const char* dir = getenv("TMPDIR");
  snprintf(buf, n, "%s/%s", dir && *dir ? dir : "/tmp", name);
  return buf;
}

int main(void) {
  assert(flexflow_init() == 0);
  flexflow_config_t cfg = flexflow_config_create(/*batch*/ 32, /*epochs*/ 1,
                                                 /*devices*/ 0);
  flexflow_model_t model = flexflow_model_create(cfg);

  int in_dims[2] = {32, 8};
  flexflow_tensor_t input = flexflow_tensor_create(model, 2, in_dims, "float32");
  flexflow_tensor_t t = flexflow_model_add_dense(model, input, 32, /*relu*/ 1,
                                                 1, "fc1");
  t = flexflow_model_add_dense(model, t, 4, /*none*/ 0, 1, "fc2");
  t = flexflow_model_add_softmax(model, t, "softmax");

  const char* metrics[] = {"accuracy", "sparse_categorical_crossentropy"};
  assert(flexflow_model_compile(model, "sgd", 0.5,
                                "sparse_categorical_crossentropy", metrics,
                                2) == 0);
  assert(flexflow_model_init_layers(model) == 0);

  /* learnable task: label = argmax(x[:4]) */
  float x[32 * 8];
  int32_t y[32];
  srand(7);
  for (int i = 0; i < 32; i++) {
    int best = 0;
    for (int j = 0; j < 8; j++) {
      x[i * 8 + j] = (float)rand() / RAND_MAX - 0.5f;
      if (j < 4 && x[i * 8 + j] > x[i * 8 + best]) best = j;
    }
    y[i] = best;
  }

  for (int step = 0; step < 40; step++) {
    if (step == 30) flexflow_model_reset_metrics(model);
    assert(flexflow_model_set_input_f32(model, input, x, 32 * 8) == 0);
    assert(flexflow_model_set_label_i32(model, y, 32) == 0);
    assert(flexflow_model_forward(model) == 0);
    assert(flexflow_model_zero_gradients(model) == 0);
    assert(flexflow_model_backward(model) == 0);
    assert(flexflow_model_update(model) == 0);
  }
  flexflow_model_sync(model);
  int64_t all = 0, correct = 0;
  double acc = flexflow_model_get_accuracy(model, &all, &correct);
  printf("C API accuracy: %.2f%% (%lld/%lld)\n", acc, (long long)correct,
         (long long)all);
  assert(acc > 60.0);
  assert(flexflow_model_get_metric(model, "sparse_cce_loss") >= 0.0);

  /* fused train step via the staged batch */
  assert(flexflow_model_set_input_f32(model, input, x, 32 * 8) == 0);
  assert(flexflow_model_set_label_i32(model, y, 32) == 0);
  assert(flexflow_model_train_iteration(model) == 0);
  assert(flexflow_model_sync(model) == 0);

  /* parameter get/set round-trip (reference: Parameter::get/set_weights) */
  int64_t vol = flexflow_parameter_get_volume(model, "fc1", "kernel");
  assert(vol == 8 * 32);
  float* w = (float*)malloc(sizeof(float) * vol);
  assert(flexflow_model_get_parameter_f32(model, "fc1", "kernel", w, vol) == 0);
  w[0] += 1.0f;
  assert(flexflow_model_set_parameter_f32(model, "fc1", "kernel", w, vol) == 0);
  float* w2 = (float*)malloc(sizeof(float) * vol);
  assert(flexflow_model_get_parameter_f32(model, "fc1", "kernel", w2, vol) == 0);
  assert(w2[0] > w[0] - 1e-3f && w2[0] < w[0] + 1e-3f);
  free(w);
  free(w2);

  /* strategy export */
  char path[4096];
  assert(flexflow_model_export_strategy(
             model, tmp_path(path, sizeof path, "capi_strategy.pb")) == 0);

  /* checkpoint save/load round-trip */
  assert(flexflow_model_save(model, tmp_path(path, sizeof path,
                                             "capi_ckpt.npz")) == 0);
  assert(flexflow_model_load(model, path) == 0);

  flexflow_model_destroy(model);
  flexflow_config_destroy(cfg);

  /* elementwise builders compile into a second graph */
  flexflow_config_t cfg2 = flexflow_config_create(8, 1, 0);
  flexflow_model_t m2 = flexflow_model_create(cfg2);
  int d2[2] = {8, 16};
  flexflow_tensor_t a = flexflow_tensor_create(m2, 2, d2, "float32");
  flexflow_tensor_t b = flexflow_tensor_create(m2, 2, d2, "float32");
  flexflow_tensor_t s = flexflow_model_add_subtract(m2, a, b, NULL);
  s = flexflow_model_add_multiply(m2, s, b, NULL);
  s = flexflow_model_add_relu(m2, s, NULL);
  s = flexflow_model_add_tanh(m2, s, NULL);
  s = flexflow_model_add_dense(m2, s, 4, 0, 1, "head");
  s = flexflow_model_add_softmax(m2, s, NULL);
  assert(s.impl != NULL);
  const char* mets2[] = {"accuracy"};
  assert(flexflow_model_compile(m2, "adam", 0.001,
                                "sparse_categorical_crossentropy", mets2,
                                1) == 0);
  assert(flexflow_model_init_layers(m2) == 0);
  flexflow_model_destroy(m2);
  flexflow_config_destroy(cfg2);

  /* ---- extended surface (reference parity) ------------------------- */

  /* config accessors + optimizer/initializer objects + builders _v2 +
     deferred (functional) builders + dataloaders + attach/inline-map */
  flexflow_config_t cfg3 = flexflow_config_create(16, 2, 0);
  assert(flexflow_config_parse_args_default(cfg3) == 0);
  assert(flexflow_config_get_batch_size(cfg3) == 16);
  assert(flexflow_config_get_epochs(cfg3) == 2);
  assert(flexflow_config_get_num_nodes(cfg3) >= 1);
  assert(flexflow_config_get_workers_per_node(cfg3) >= 1);

  flexflow_model_t m3 = flexflow_model_create(cfg3);
  int d3[2] = {16, 8};
  flexflow_tensor_t in3 = flexflow_tensor_create(m3, 2, d3, "float32");
  assert(flexflow_tensor_get_num_dims(in3) == 2);
  assert(flexflow_tensor_get_data_type(in3) == 0);

  flexflow_glorot_uniform_initializer_t gi =
      flexflow_glorot_uniform_initializer_create(3);
  flexflow_zero_initializer_t zi = flexflow_zero_initializer_create();
  flexflow_initializer_t ki = {gi.impl};
  flexflow_initializer_t bi = {zi.impl};
  flexflow_tensor_t t3 =
      flexflow_model_add_dense_v2(m3, in3, 32, 1, 1, ki, bi, "v2fc1");
  assert(t3.impl != NULL);

  /* deferred-shape (functional) builder: dense bound to its input later */
  flexflow_op_t dop = flexflow_model_add_dense_no_inout(m3, 4, 0, 1, "v2fc2");
  flexflow_tensor_t t4 = flexflow_op_init_inout(dop, m3, t3);
  assert(t4.impl != NULL);
  assert(flexflow_op_add_to_model(dop, m3) == 0);
  flexflow_tensor_t t4b = flexflow_op_get_output_by_id(dop, 0);
  assert(t4b.impl != NULL);
  flexflow_tensor_t sm3 = flexflow_model_add_softmax(m3, t4, "v2sm");
  assert(sm3.impl != NULL);

  /* optimizer object bound ahead of compile (optimizer="") */
  flexflow_sgd_optimizer_t sgd =
      flexflow_sgd_optimizer_create(m3, 0.1, 0.0, 0, 0.0);
  flexflow_sgd_optimizer_set_lr(sgd, 0.5);
  assert(flexflow_model_set_sgd_optimizer(m3, sgd) == 0);
  const char* mets3[] = {"accuracy"};
  assert(flexflow_model_compile(m3, "", 0.0,
                                "sparse_categorical_crossentropy", mets3,
                                1) == 0);
  assert(flexflow_model_init_layers(m3) == 0);
  assert(flexflow_model_get_num_layers(m3) == 3);

  /* op + parameter handles */
  flexflow_op_t l0 = flexflow_model_get_layer_by_id(m3, 0);
  flexflow_tensor_t l0in = flexflow_op_get_input_by_id(l0, 0);
  flexflow_tensor_t l0out = flexflow_op_get_output_by_id(l0, 0);
  assert(l0in.impl && l0out.impl);
  flexflow_op_t owner = flexflow_tensor_get_owner_op(l0out);
  assert(owner.impl != NULL);
  flexflow_parameter_t k0 = flexflow_op_get_parameter_by_id(l0, 0);
  assert(k0.impl != NULL);
  assert(flexflow_parameter_get_volume_v2(k0) == 8 * 32);
  float* wv = (float*)malloc(sizeof(float) * 8 * 32);
  assert(flexflow_parameter_get_weights_float(k0, wv, 8 * 32) == 0);
  assert(flexflow_parameter_set_weights_float(k0, wv, 8 * 32) == 0);
  free(wv);
  flexflow_parameter_t p0 = flexflow_model_get_parameter_by_id(m3, 0);
  assert(p0.impl != NULL);

  /* label tensor exists post-compile */
  flexflow_tensor_t lbl = flexflow_model_get_label_tensor(m3);
  assert(lbl.impl != NULL);
  flexflow_model_print_layers(m3, -1);
  assert(flexflow_model_prefetch(m3) == 0);

  /* dataloaders: full dataset host-resident, per-step slice staging */
  enum { NS = 64 };
  static float xs3[NS * 8];
  static int32_t ys3[NS];
  for (int i = 0; i < NS; i++) {
    int best = 0;
    for (int j = 0; j < 8; j++) {
      xs3[i * 8 + j] = (float)rand() / RAND_MAX - 0.5f;
      if (j < 4 && xs3[i * 8 + j] > xs3[i * 8 + best]) best = j;
    }
    ys3[i] = best;
  }
  flexflow_dataloader_2d_t dl =
      flexflow_dataloader_2d_create(m3, in3, xs3, ys3, NS);
  assert(dl.impl != NULL);
  assert(flexflow_dataloader_2d_get_num_samples(dl) == NS);
  flexflow_dataloader_2d_set_num_samples(dl, NS);
  flexflow_dataloader_2d_reset(dl);
  double t_start = flexflow_get_current_time(m3);
  /* four epochs; the accuracy is that of the last two.  This library's
     glorot draws other numbers than the first library's (the same bounds),
     and from these the first two epochs stay near chance; from the first
     library's draws they give its accuracy.  capi_parity.c's loader job
     holds this path against the first library from the same weights. */
  for (int e = 0; e < 4; e++) {
    if (e == 2) flexflow_model_reset_metrics(m3);
    flexflow_begin_trace(m3, 111);
    for (int it = 0; it < NS / 16; it++) {
      assert(flexflow_dataloader_2d_next_batch(dl, m3) == 0);
      assert(flexflow_model_train_iteration(m3) == 0);
    }
    flexflow_end_trace(m3, 111);
  }
  assert(flexflow_model_sync(m3) == 0);
  assert(flexflow_get_current_time(m3) > t_start);
  assert(flexflow_model_compute_metrics(m3) == 0);
  flexflow_perf_metrics_t pm = flexflow_model_get_perf_metrics(m3);
  assert(pm.impl != NULL);
  float acc3 = flexflow_per_metrics_get_accuracy(pm);
  printf("C API extended: dataloader-trained accuracy %.2f%%\n", acc3);
  assert(acc3 > 30.0f);
  flexflow_per_metrics_destroy(pm);
  flexflow_dataloader_2d_destroy(dl);

  /* attach_raw_ptr (a zero-copy view on the host) + single dataloader + inline map */
  assert(flexflow_tensor_attach_raw_ptr(m3, in3, xs3, NS * 8, 1) == 0);
  flexflow_single_dataloader_t sdl =
      flexflow_single_dataloader_create(m3, in3, NULL, NS, 1, 0);
  assert(sdl.impl != NULL);
  assert(flexflow_single_dataloader_get_num_samples(sdl) == NS);
  assert(flexflow_single_dataloader_next_batch(sdl, m3) == 0);
  assert(flexflow_tensor_inline_map(m3, in3) == 0);
  assert(flexflow_tensor_is_mapped(m3, in3) == 1);
  float* raw = flexflow_tensor_get_raw_ptr_float(m3, in3);
  assert(raw != NULL);
  assert(raw[0] == xs3[0]);  /* attached view aliases the caller's memory */
  flexflow_tensor_inline_unmap(m3, in3);
  assert(flexflow_tensor_is_mapped(m3, in3) == 0);
  assert(flexflow_tensor_detach_raw_ptr(m3, in3) == 0);
  flexflow_single_dataloader_destroy(sdl);

  /* MoE layer through the C surface */
  {
    flexflow_config_t mc = flexflow_config_create(8, 1, 0);
    flexflow_model_t mm = flexflow_model_create(mc);
    int md[2] = {8, 16};
    flexflow_tensor_t mi = flexflow_tensor_create(mm, 2, md, "float32");
    flexflow_tensor_t mo =
        flexflow_model_add_expert_mlp(mm, mi, 4, 32, 1.25, "moe");
    assert(mo.impl != NULL);
    flexflow_tensor_t mh = flexflow_model_add_dense(mm, mo, 4, 0, 1, "h");
    mh = flexflow_model_add_softmax(mm, mh, NULL);
    const char* mmet[] = {"accuracy"};
    assert(flexflow_model_compile(mm, "sgd", 0.1,
                                  "sparse_categorical_crossentropy", mmet,
                                  1) == 0);
    assert(flexflow_model_init_layers(mm) == 0);
    flexflow_model_destroy(mm);
    flexflow_config_destroy(mc);
  }

  /* adam object + net config */
  flexflow_adam_optimizer_t adam =
      flexflow_adam_optimizer_create(m3, 0.001, 0.9, 0.999, 0.0, 1e-8);
  flexflow_adam_optimizer_set_lr(adam, 0.002);
  assert(flexflow_model_set_adam_optimizer(m3, adam) == 0);
  flexflow_adam_optimizer_destroy(adam);
  flexflow_net_config_t nc = flexflow_net_config_create();
  assert(flexflow_net_config_get_dataset_path(nc) != NULL);
  flexflow_net_config_destroy(nc);

  flexflow_sgd_optimizer_destroy(sgd);
  flexflow_glorot_uniform_initializer_destroy(gi);
  flexflow_zero_initializer_destroy(zi);
  flexflow_op_destroy(l0);
  flexflow_op_destroy(owner);
  flexflow_parameter_destroy(k0);
  flexflow_parameter_destroy(p0);
  flexflow_model_destroy(m3);
  flexflow_config_destroy(cfg3);

  printf("C API smoke test: OK\n");
  return 0;
}
