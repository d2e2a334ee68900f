"""Decoder models of the dense, moe, mla_moe, ssm and hybrid families in
PyTorch (counterpart of ``repro.models``)."""

from .model import (Model, ModelConfig, active_params, build_model,
                    cache_axes, cache_seq_axes, count_params, decode_fn,
                    init_cache, init_params, loss_and_grads, loss_fn,
                    make_prefill_step, make_serve_step, make_train_step,
                    prefill_fn)

__all__ = ["Model", "ModelConfig", "active_params", "build_model",
           "cache_axes", "cache_seq_axes", "count_params", "decode_fn",
           "init_cache", "init_params", "loss_and_grads", "loss_fn",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "prefill_fn"]
