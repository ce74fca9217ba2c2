/* C API of flexflow_tpu_torch, the PyTorch/CUDA port.
 *
 * Counterpart of the reference C API (reference: python/flexflow_c.h —
 * extern "C" wrappers with opaque handle structs over FFModel).  The core
 * of this framework is Python, so the library (flexflow_c.cpp) embeds
 * CPython and drives flexflow_tpu_torch's FFModel: C callers get the
 * reference-style surface (opaque handles, flexflow_model_add_* builders,
 * compile/train-step calls) with the CUDA execution engine underneath.
 * The names, signatures and handle types are those of the repository's
 * first C library (native/flexflow_c.h), so a C program links against
 * either one unchanged.
 *
 * Build: python -m flexflow_tpu_torch.native.capi builds the library and
 * prints its path and this header's; link with -lflexflow_c and the
 * Python runtime (python3-config --ldflags --embed).
 *
 * Device: FLEXFLOW_TORCH_DEVICE=cuda (the default) or cpu sets
 * FFConfig.device in flexflow_config_create; "--device" in
 * flexflow_config_parse_args overrides it.  Without a GPU and without
 * FLEXFLOW_TORCH_DEVICE=cpu, flexflow_model_create fails (a null handle,
 * the error printed): nothing falls back to the CPU.
 *
 * Calls may come from any thread: each takes the interpreter's lock.
 */

#ifndef FLEXFLOW_TORCH_C_H
#define FLEXFLOW_TORCH_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct flexflow_config_t { void* impl; } flexflow_config_t;
typedef struct flexflow_model_t { void* impl; } flexflow_model_t;
typedef struct flexflow_tensor_t { void* impl; } flexflow_tensor_t;

/* runtime */
int flexflow_init(void);          /* idempotent; returns 0 on success */
void flexflow_finalize(void);

/* config (reference: flexflow_config_create / parse_args) */
flexflow_config_t flexflow_config_create(int batch_size, int epochs,
                                         int num_devices);
void flexflow_config_destroy(flexflow_config_t c);

/* model + tensors */
flexflow_model_t flexflow_model_create(flexflow_config_t c);
void flexflow_model_destroy(flexflow_model_t m);
/* dims reference-ordered (N,C,H,W for 4-D); dtype "float32"|"int32"|"int64" */
flexflow_tensor_t flexflow_tensor_create(flexflow_model_t m, int ndims,
                                         const int* dims, const char* dtype);
void flexflow_tensor_destroy(flexflow_tensor_t t);

/* layer builders (reference: flexflow_model_add_*; activation:
 * 0=none 1=relu 2=sigmoid 3=tanh) */
flexflow_tensor_t flexflow_model_add_conv2d(
    flexflow_model_t m, flexflow_tensor_t input, int out_channels,
    int kernel_h, int kernel_w, int stride_h, int stride_w,
    int padding_h, int padding_w, int activation, int use_bias,
    const char* name);
flexflow_tensor_t flexflow_model_add_pool2d(
    flexflow_model_t m, flexflow_tensor_t input, int kernel_h, int kernel_w,
    int stride_h, int stride_w, int padding_h, int padding_w,
    int pool_max /*1=max 0=avg*/, const char* name);
flexflow_tensor_t flexflow_model_add_dense(
    flexflow_model_t m, flexflow_tensor_t input, int out_dim, int activation,
    int use_bias, const char* name);
flexflow_tensor_t flexflow_model_add_flat(flexflow_model_t m,
                                          flexflow_tensor_t input,
                                          const char* name);
flexflow_tensor_t flexflow_model_add_softmax(flexflow_model_t m,
                                             flexflow_tensor_t input,
                                             const char* name);
flexflow_tensor_t flexflow_model_add_embedding(
    flexflow_model_t m, flexflow_tensor_t input, int num_entries, int out_dim,
    int aggr_sum /*1=sum 0=avg*/, const char* name);
flexflow_tensor_t flexflow_model_add_concat(
    flexflow_model_t m, int n, const flexflow_tensor_t* inputs, int axis,
    const char* name);
flexflow_tensor_t flexflow_model_add_add(flexflow_model_t m,
                                         flexflow_tensor_t a,
                                         flexflow_tensor_t b,
                                         const char* name);
flexflow_tensor_t flexflow_model_add_subtract(flexflow_model_t m,
                                              flexflow_tensor_t a,
                                              flexflow_tensor_t b,
                                              const char* name);
flexflow_tensor_t flexflow_model_add_multiply(flexflow_model_t m,
                                              flexflow_tensor_t a,
                                              flexflow_tensor_t b,
                                              const char* name);
flexflow_tensor_t flexflow_model_add_divide(flexflow_model_t m,
                                            flexflow_tensor_t a,
                                            flexflow_tensor_t b,
                                            const char* name);
flexflow_tensor_t flexflow_model_add_relu(flexflow_model_t m,
                                          flexflow_tensor_t input,
                                          const char* name);
flexflow_tensor_t flexflow_model_add_sigmoid(flexflow_model_t m,
                                             flexflow_tensor_t input,
                                             const char* name);
flexflow_tensor_t flexflow_model_add_tanh(flexflow_model_t m,
                                          flexflow_tensor_t input,
                                          const char* name);
flexflow_tensor_t flexflow_model_add_elu(flexflow_model_t m,
                                         flexflow_tensor_t input,
                                         const char* name);
flexflow_tensor_t flexflow_model_add_exp(flexflow_model_t m,
                                         flexflow_tensor_t input,
                                         const char* name);
flexflow_tensor_t flexflow_model_add_batch_norm(flexflow_model_t m,
                                                flexflow_tensor_t input,
                                                int relu, const char* name);
flexflow_tensor_t flexflow_model_add_dropout(flexflow_model_t m,
                                             flexflow_tensor_t input,
                                             double rate, int seed,
                                             const char* name);
flexflow_tensor_t flexflow_model_add_mse_loss(flexflow_model_t m,
                                              flexflow_tensor_t logits,
                                              flexflow_tensor_t labels,
                                              const char* reduction,
                                              const char* name);

/* compile: optimizer "sgd"|"adam"; loss per reference names */
int flexflow_model_compile(flexflow_model_t m, const char* optimizer,
                           double lr, const char* loss,
                           const char** metrics, int num_metrics);
int flexflow_model_init_layers(flexflow_model_t m);

/* batch feeding (host data, reference-ordered layout) */
int flexflow_model_set_input_f32(flexflow_model_t m, flexflow_tensor_t t,
                                 const float* data, int64_t count);
int flexflow_model_set_input_i32(flexflow_model_t m, flexflow_tensor_t t,
                                 const int32_t* data, int64_t count);
int flexflow_model_set_label_i32(flexflow_model_t m, const int32_t* data,
                                 int64_t count);
int flexflow_model_set_label_f32(flexflow_model_t m, const float* data,
                                 int64_t count);

/* train drivers (reference: forward/zero_gradients/backward/update) */
int flexflow_model_forward(flexflow_model_t m);
int flexflow_model_zero_gradients(flexflow_model_t m);
int flexflow_model_backward(flexflow_model_t m);
int flexflow_model_update(flexflow_model_t m);
int flexflow_model_sync(flexflow_model_t m);
void flexflow_model_reset_metrics(flexflow_model_t m);

/* fused train step (staged batch must be set) */
int flexflow_model_train_iteration(flexflow_model_t m);

/* metrics: returns accuracy %; train_all/correct optional out-params */
double flexflow_model_get_accuracy(flexflow_model_t m, int64_t* train_all,
                                   int64_t* train_correct);
/* any PerfMetrics field by name ("accuracy", "cce_loss", "sparse_cce_loss",
 * "mse_loss", "rmse_loss", "mae_loss", "train_all", "train_correct") */
double flexflow_model_get_metric(flexflow_model_t m, const char* name);

/* weights (reference: Parameter::get_weights/set_weights) */
int64_t flexflow_parameter_get_volume(flexflow_model_t m, const char* op_name,
                                      const char* weight_name);
int flexflow_model_get_parameter_f32(flexflow_model_t m, const char* op_name,
                                     const char* weight_name, float* out,
                                     int64_t count);
int flexflow_model_set_parameter_f32(flexflow_model_t m, const char* op_name,
                                     const char* weight_name,
                                     const float* data, int64_t count);

/* strategy files (reference: --import-strategy / --export-strategy) */
int flexflow_config_import_strategy(flexflow_config_t c, const char* path);
int flexflow_model_export_strategy(flexflow_model_t m, const char* path);

/* checkpoint / resume */
int flexflow_model_save(flexflow_model_t m, const char* path);
int flexflow_model_load(flexflow_model_t m, const char* path);

/* tensor introspection */
int flexflow_tensor_get_dims(flexflow_tensor_t t, int* dims /*>=4 slots*/);

/* ----------------------------------------------------------------------
 * Extended surface: parity with the reference C API
 * (reference: python/flexflow_c.h:27-718 — config accessors, optimizer /
 * initializer / NetConfig objects, dataloader handles, tensor raw-ptr
 * attach + inline map, op handles and the deferred-shape builders).
 * -------------------------------------------------------------------- */

typedef struct flexflow_sgd_optimizer_t { void* impl; } flexflow_sgd_optimizer_t;
typedef struct flexflow_adam_optimizer_t { void* impl; } flexflow_adam_optimizer_t;
typedef struct flexflow_initializer_t { void* impl; } flexflow_initializer_t;
typedef struct flexflow_glorot_uniform_initializer_t { void* impl; } flexflow_glorot_uniform_initializer_t;
typedef struct flexflow_zero_initializer_t { void* impl; } flexflow_zero_initializer_t;
typedef struct flexflow_uniform_initializer_t { void* impl; } flexflow_uniform_initializer_t;
typedef struct flexflow_norm_initializer_t { void* impl; } flexflow_norm_initializer_t;
typedef struct flexflow_net_config_t { void* impl; } flexflow_net_config_t;
typedef struct flexflow_op_t { void* impl; } flexflow_op_t;
typedef struct flexflow_parameter_t { void* impl; } flexflow_parameter_t;
typedef struct flexflow_perf_metrics_t { void* impl; } flexflow_perf_metrics_t;
typedef struct flexflow_dataloader_4d_t { void* impl; } flexflow_dataloader_4d_t;
typedef struct flexflow_dataloader_2d_t { void* impl; } flexflow_dataloader_2d_t;
typedef struct flexflow_single_dataloader_t { void* impl; } flexflow_single_dataloader_t;

/* config accessors (reference: flexflow_config_get_*) */
int flexflow_config_parse_args(flexflow_config_t c, int argc, char** argv);
int flexflow_config_parse_args_default(flexflow_config_t c);
int flexflow_config_get_batch_size(flexflow_config_t c);
int flexflow_config_get_epochs(flexflow_config_t c);
int flexflow_config_get_num_nodes(flexflow_config_t c);
int flexflow_config_get_workers_per_node(flexflow_config_t c);

/* optimizer objects (reference: optimizer.cc semantics) */
flexflow_sgd_optimizer_t flexflow_sgd_optimizer_create(
    flexflow_model_t m, double lr, double momentum, int nesterov,
    double weight_decay);
void flexflow_sgd_optimizer_destroy(flexflow_sgd_optimizer_t o);
void flexflow_sgd_optimizer_set_lr(flexflow_sgd_optimizer_t o, double lr);
flexflow_adam_optimizer_t flexflow_adam_optimizer_create(
    flexflow_model_t m, double alpha, double beta1, double beta2,
    double weight_decay, double epsilon);
void flexflow_adam_optimizer_destroy(flexflow_adam_optimizer_t o);
void flexflow_adam_optimizer_set_lr(flexflow_adam_optimizer_t o, double lr);
/* bind for the next compile; pass optimizer="" to flexflow_model_compile */
int flexflow_model_set_sgd_optimizer(flexflow_model_t m,
                                     flexflow_sgd_optimizer_t o);
int flexflow_model_set_adam_optimizer(flexflow_model_t m,
                                      flexflow_adam_optimizer_t o);

/* initializer objects (reference: initializer.h:26-100) */
flexflow_initializer_t flexflow_initializer_create_null(void);
flexflow_glorot_uniform_initializer_t
flexflow_glorot_uniform_initializer_create(int seed);
void flexflow_glorot_uniform_initializer_destroy(
    flexflow_glorot_uniform_initializer_t i);
flexflow_zero_initializer_t flexflow_zero_initializer_create(void);
void flexflow_zero_initializer_destroy(flexflow_zero_initializer_t i);
flexflow_uniform_initializer_t flexflow_uniform_initializer_create(
    int seed, float min_val, float max_val);
void flexflow_uniform_initializer_destroy(flexflow_uniform_initializer_t i);
flexflow_norm_initializer_t flexflow_norm_initializer_create(
    int seed, float mean, float stddev);
void flexflow_norm_initializer_destroy(flexflow_norm_initializer_t i);

/* builder variants taking initializer handles (pass {NULL} for default) */
flexflow_tensor_t flexflow_model_add_dense_v2(
    flexflow_model_t m, flexflow_tensor_t input, int out_dim, int activation,
    int use_bias, flexflow_initializer_t kernel_init,
    flexflow_initializer_t bias_init, const char* name);
flexflow_tensor_t flexflow_model_add_conv2d_v2(
    flexflow_model_t m, flexflow_tensor_t input, int out_channels,
    int kernel_h, int kernel_w, int stride_h, int stride_w, int padding_h,
    int padding_w, int activation, int use_bias,
    flexflow_initializer_t kernel_init, flexflow_initializer_t bias_init,
    const char* name);

/* Switch-style MoE layer; expert weights shard over config dim 1 */
flexflow_tensor_t flexflow_model_add_expert_mlp(
    flexflow_model_t m, flexflow_tensor_t input, int num_experts,
    int hidden_size, double capacity_factor, const char* name);

/* NetConfig (reference: --dataset flag carrier) */
flexflow_net_config_t flexflow_net_config_create(void);
void flexflow_net_config_destroy(flexflow_net_config_t c);
const char* flexflow_net_config_get_dataset_path(flexflow_net_config_t c);

/* deferred-shape (functional) builders: create the op descriptor now,
 * bind the input later (reference: *_no_inout + op_init_inout) */
flexflow_op_t flexflow_model_add_conv2d_no_inout(
    flexflow_model_t m, int out_channels, int kernel_h, int kernel_w,
    int stride_h, int stride_w, int padding_h, int padding_w, int activation,
    int use_bias, const char* name);
flexflow_op_t flexflow_model_add_dense_no_inout(
    flexflow_model_t m, int out_dim, int activation, int use_bias,
    const char* name);
flexflow_op_t flexflow_model_add_pool2d_no_inout(
    flexflow_model_t m, int kernel_h, int kernel_w, int stride_h,
    int stride_w, int padding_h, int padding_w, int pool_max,
    const char* name);
flexflow_op_t flexflow_model_add_flat_no_inout(flexflow_model_t m,
                                               const char* name);
flexflow_tensor_t flexflow_op_init_inout(flexflow_op_t op, flexflow_model_t m,
                                         flexflow_tensor_t input);
int flexflow_op_add_to_model(flexflow_op_t op, flexflow_model_t m);
int flexflow_op_init(flexflow_op_t op, flexflow_model_t m);
int flexflow_op_forward(flexflow_op_t op, flexflow_model_t m);

/* op / parameter handles (reference: model_get_layer_by_id etc.) */
int flexflow_model_get_num_layers(flexflow_model_t m);
flexflow_op_t flexflow_model_get_layer_by_id(flexflow_model_t m, int id);
void flexflow_op_destroy(flexflow_op_t op);
flexflow_tensor_t flexflow_op_get_input_by_id(flexflow_op_t op, int id);
flexflow_tensor_t flexflow_op_get_output_by_id(flexflow_op_t op, int id);
flexflow_parameter_t flexflow_op_get_parameter_by_id(flexflow_op_t op, int id);
flexflow_parameter_t flexflow_model_get_parameter_by_id(flexflow_model_t m,
                                                        int id);
void flexflow_parameter_destroy(flexflow_parameter_t p);
int64_t flexflow_parameter_get_volume_v2(flexflow_parameter_t p);
int flexflow_parameter_get_weights_float(flexflow_parameter_t p, float* out,
                                         int64_t count);
int flexflow_parameter_set_weights_float(flexflow_parameter_t p,
                                         const float* data, int64_t count);

/* label tensor + layer printing */
flexflow_tensor_t flexflow_model_get_label_tensor(flexflow_model_t m);
void flexflow_model_print_layers(flexflow_model_t m, int id /* -1 = all */);
int flexflow_model_prefetch(flexflow_model_t m);

/* perf metrics handle (reference: model_get_perf_metrics +
 * per_metrics_get_accuracy; the short "per_metrics" spelling matches the
 * reference header) */
flexflow_perf_metrics_t flexflow_model_get_perf_metrics(flexflow_model_t m);
void flexflow_per_metrics_destroy(flexflow_perf_metrics_t p);
float flexflow_per_metrics_get_accuracy(flexflow_perf_metrics_t p);
int flexflow_model_compute_metrics(flexflow_model_t m);

/* tracing + timing (reference: begin/end_trace replay Legion traces; on
 * one GPU the whole training step is one captured CUDA graph, replayed
 * every step, so these are semantic no-ops kept for source compatibility) */
void flexflow_begin_trace(flexflow_model_t m, int trace_id);
void flexflow_end_trace(flexflow_model_t m, int trace_id);
double flexflow_get_current_time(flexflow_model_t m); /* microseconds */

/* raw-pointer attach (reference: Tensor::attach_raw_ptr model.cc:73-93 —
 * zero-copy host data; here the pointer is wrapped as a numpy view, shaped
 * (-1, dims[1:]) in the tensor's native order, and stays on the host: each
 * batch taken from it is copied to the device) */
int flexflow_tensor_attach_raw_ptr(flexflow_model_t m, flexflow_tensor_t t,
                                   void* ptr, int64_t count,
                                   int is_float /*1=f32 0=i32*/);
int flexflow_tensor_detach_raw_ptr(flexflow_model_t m, flexflow_tensor_t t);
/* inline map: a host copy of the tensor's current data (attached, staged,
 * or else the batch on the device, copied from it) behind a raw pointer */
int flexflow_tensor_inline_map(flexflow_model_t m, flexflow_tensor_t t);
void flexflow_tensor_inline_unmap(flexflow_model_t m, flexflow_tensor_t t);
int flexflow_tensor_is_mapped(flexflow_model_t m, flexflow_tensor_t t);
float* flexflow_tensor_get_raw_ptr_float(flexflow_model_t m,
                                         flexflow_tensor_t t);
int32_t* flexflow_tensor_get_raw_ptr_int32(flexflow_model_t m,
                                           flexflow_tensor_t t);
int flexflow_tensor_get_num_dims(flexflow_tensor_t t);
int flexflow_tensor_get_data_type(flexflow_tensor_t t); /* 0=f32 1=i32 2=i64 */
flexflow_op_t flexflow_tensor_get_owner_op(flexflow_tensor_t t);

/* dataloader handles (reference: flexflow_dataloader_{4d,2d} +
 * single_dataloader — full dataset host-resident, per-step batch scatter).
 * create: input + label arrays together; create_v2: one tensor's data only. */
flexflow_dataloader_4d_t flexflow_dataloader_4d_create(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    const int32_t* full_label, int64_t num_samples);
flexflow_dataloader_4d_t flexflow_dataloader_4d_create_v2(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    int64_t num_samples);
void flexflow_dataloader_4d_destroy(flexflow_dataloader_4d_t d);
void flexflow_dataloader_4d_reset(flexflow_dataloader_4d_t d);
int flexflow_dataloader_4d_next_batch(flexflow_dataloader_4d_t d,
                                      flexflow_model_t m);
int64_t flexflow_dataloader_4d_get_num_samples(flexflow_dataloader_4d_t d);
void flexflow_dataloader_4d_set_num_samples(flexflow_dataloader_4d_t d,
                                            int64_t n);
flexflow_dataloader_2d_t flexflow_dataloader_2d_create(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    const int32_t* full_label, int64_t num_samples);
flexflow_dataloader_2d_t flexflow_dataloader_2d_create_v2(
    flexflow_model_t m, flexflow_tensor_t input, const float* full_input,
    int64_t num_samples);
void flexflow_dataloader_2d_destroy(flexflow_dataloader_2d_t d);
void flexflow_dataloader_2d_reset(flexflow_dataloader_2d_t d);
int flexflow_dataloader_2d_next_batch(flexflow_dataloader_2d_t d,
                                      flexflow_model_t m);
int64_t flexflow_dataloader_2d_get_num_samples(flexflow_dataloader_2d_t d);
void flexflow_dataloader_2d_set_num_samples(flexflow_dataloader_2d_t d,
                                            int64_t n);
/* any-rank, any-dtype single-tensor loader (reference: SingleDataLoader) */
flexflow_single_dataloader_t flexflow_single_dataloader_create(
    flexflow_model_t m, flexflow_tensor_t t, const void* full_data,
    int64_t num_samples, int is_float /*1=f32 0=i32*/,
    int is_label /*feed as label instead of input*/);
void flexflow_single_dataloader_destroy(flexflow_single_dataloader_t d);
void flexflow_single_dataloader_reset(flexflow_single_dataloader_t d);
int flexflow_single_dataloader_next_batch(flexflow_single_dataloader_t d,
                                          flexflow_model_t m);
int64_t flexflow_single_dataloader_get_num_samples(
    flexflow_single_dataloader_t d);
void flexflow_single_dataloader_set_num_samples(flexflow_single_dataloader_t d,
                                                int64_t n);

#ifdef __cplusplus
}
#endif

#endif /* FLEXFLOW_TORCH_C_H */
