"""Functional models of the reference's ten architectures (dense and MoE
GQA decoders, the RG-LRU hybrid, the xLSTM family, the encoder-decoder
and the M-RoPE VLM), with SiLQ quantization sites."""
from repro_torch.models.model import (clone_cache, decode_step, forward,
                                      head_logits, init_cache, init_params,
                                      prefill, prefill_tail, spec_verify)

__all__ = ["clone_cache", "decode_step", "forward", "head_logits",
           "init_cache", "init_params", "prefill", "prefill_tail",
           "spec_verify"]
