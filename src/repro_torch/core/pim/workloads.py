"""LLM workload inventories for the LamaAccel evaluation (paper §V-D,
Table VI): BERT-base, BART-large, GPT-2-small across five NLP tasks.
Port of the JAX package's ``core/pim/workloads.py``.

Each workload is flattened into a list of GEMM layer descriptors with a
per-layer exponent bitwidth synthesized to hit the Table VI per-task
average ("Avg bit") — the quantity that drives LamaAccel's parallelism
degree p(bits) and hence its relative speed/energy.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GemmLayer:
    """One int GEMM: [m, k] x [k, n]; m carries the token dimension."""

    name: str
    m: int
    k: int
    n: int
    bits: int            # DNA-TEQ exponent width for this layer
    serial_steps: int = 1  # >1 for autoregressive decoder layers

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.serial_steps


@dataclass(frozen=True)
class Workload:
    name: str
    model: str
    task: str
    seq_len: int
    avg_bits: float                     # Table VI
    layers: tuple[GemmLayer, ...]
    dec_pseudo_channel_bias: float = 1.0  # >1: extra pch for decoders (BART CNN)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)


def _bit_cycle(avg_bits: float, n: int) -> list[int]:
    """Integer per-layer bitwidths (3..7) averaging ~avg_bits."""
    lo, hi = int(avg_bits), min(int(avg_bits) + 1, 7)
    lo = max(lo, 3)
    frac = avg_bits - int(avg_bits)
    n_hi = round(frac * n)
    bits = [hi] * n_hi + [lo] * (n - n_hi)
    # interleave for realism
    out, a, b = [], 0, n_hi
    for i in range(n):
        if i % 2 == 0 and a < n_hi:
            out.append(hi); a += 1
        elif b < n:
            out.append(lo); b += 1
        else:
            out.append(hi)
    return out


def _transformer_layers(
    prefix: str,
    n_blocks: int,
    d: int,
    d_ff: int,
    seq: int,
    bits_seq: list[int],
    cross: bool = False,
    serial_steps: int = 1,
) -> list[GemmLayer]:
    """FC + attention GEMMs for ``n_blocks`` transformer blocks.

    Attention score/value GEMMs run at the activations' bitwidth; the K/V
    matrices are written into banks as FC weights (paper §V-A).
    """
    ls: list[GemmLayer] = []
    m = seq if serial_steps == 1 else 1
    for blk in range(n_blocks):
        b = bits_seq[blk % len(bits_seq)]
        add = lambda nm, mm, kk, nn: ls.append(
            GemmLayer(f"{prefix}{blk}.{nm}", mm, kk, nn, b, serial_steps)
        )
        add("qkv", m, d, 3 * d)
        add("scores", m, d, seq)     # Q x K^T  (K as weights)
        add("attn_v", m, seq, d)     # S x V    (V as weights)
        add("proj", m, d, d)
        if cross:
            add("xattn_q", m, d, d)
            add("xattn_scores", m, d, seq)
            add("xattn_v", m, seq, d)
            add("xattn_proj", m, d, d)
        add("ffn1", m, d, d_ff)
        add("ffn2", m, d_ff, d)
    return ls


def _bert(task: str, seq: int, avg_bits: float) -> Workload:
    bits = _bit_cycle(avg_bits, 12)
    layers = _transformer_layers("enc", 12, 768, 3072, seq, bits)
    return Workload(f"BERT-{task}", "BERT-Base", task, seq, avg_bits, tuple(layers))


def _bart(task: str, seq: int, avg_bits: float, gen_tokens: int) -> Workload:
    bits = _bit_cycle(avg_bits, 24)
    enc = _transformer_layers("enc", 12, 1024, 4096, seq, bits[:12])
    dec = _transformer_layers(
        "dec", 12, 1024, 4096, seq, bits[12:], cross=True,
        serial_steps=gen_tokens,
    )
    bias = 4.0 if gen_tokens > 1 else 1.0  # paper: extra pchs for decoders
    return Workload(
        f"BART-{task}", "BART-Large", task, seq, avg_bits,
        tuple(enc + dec), dec_pseudo_channel_bias=bias,
    )


def _gpt2(task: str, seq: int, avg_bits: float) -> Workload:
    bits = _bit_cycle(avg_bits, 12)
    layers = _transformer_layers("dec", 12, 768, 3072, seq, bits)
    return Workload(f"GPT2-{task}", "GPT-2-Small", task, seq, avg_bits, tuple(layers))


def table_vi_workloads() -> list[Workload]:
    """The five evaluated (model, task) pairs with Table VI max SL / bits."""
    return [
        _bert("SQuAD1", 384, 6.45),
        _bert("SST2", 128, 3.48),
        _bart("CNN-DM", 142, 5.71, gen_tokens=142),
        _bart("MNLI", 1024, 4.88, gen_tokens=1),
        _gpt2("IMDB", 1024, 6.03),
    ]
