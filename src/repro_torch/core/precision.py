"""Named precision policies: the paper's A-C-W notation.

``A8d-C8-W4`` = 8-bit token-dynamic activations, 8-bit KV cache, 4-bit
weights. ``A8s`` = static (learned per-tensor scale) activations. The fp16
baseline is ``A16-C16-W16`` with quantization disabled entirely.

Fixed site policies (paper §3.2, Fig. 2): the head quantizes its input
and weight at 8 bits; the query into QK^T is INT16.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    enabled: bool = True
    act_bits: int = 8
    act_dynamic: bool = True          # 'd' vs 's'
    cache_bits: int = 8
    weight_bits: int = 4
    head_bits: int = 8                # head input + head weight
    query_bits: int = 16              # query operand of QK^T (static)
    softmax_out_bits: int = 16        # deploy-time only; not trained (flash)
    quantize_softmax_out: bool = False

    @property
    def acts_static(self) -> bool:
        return not self.act_dynamic


_PAT = re.compile(r"^A(\d+)([ds]?)-C(\d+)-W(\d+)$")


def parse_policy(name: str) -> PrecisionPolicy:
    """Parse 'A8d-C8-W4' style names; 'A16-C16-W16' disables quantization."""
    if name in ("A16-C16-W16", "fp16", "baseline", "none"):
        return PrecisionPolicy(name="A16-C16-W16", enabled=False,
                               act_bits=16, cache_bits=16, weight_bits=16,
                               head_bits=16)
    m = _PAT.match(name)
    if not m:
        raise ValueError(f"unparseable precision policy {name!r}")
    a, mode, c, w = int(m.group(1)), m.group(2) or "d", int(m.group(3)), int(m.group(4))
    return PrecisionPolicy(name=name, act_bits=a, act_dynamic=(mode == "d"),
                           cache_bits=c, weight_bits=w)
