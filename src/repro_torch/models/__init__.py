"""Functional model of the dense GQA decoder with SiLQ quantization sites."""
from repro_torch.models.model import (clone_cache, decode_step, forward,
                                      head_logits, init_cache, init_params,
                                      prefill, prefill_tail, spec_verify)

__all__ = ["clone_cache", "decode_step", "forward", "head_logits",
           "init_cache", "init_params", "prefill", "prefill_tail",
           "spec_verify"]
