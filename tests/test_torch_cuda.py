"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test skips without CUDA (decided inside the test, so that
every worker collects the same tests); run them on a machine with an
H100:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Covers what ``chip_smoke.py`` does not: ragged M/K/N, split-K, ALU
decode, bias and every epilogue, float32 and bfloat16 activations,
other group sizes and block sizes (one above 48 KB of shared memory),
zero-length rows, the wrappers' refusals, small engines (float and
codes mode) served on the card against the same engine on the CPU, the
attention kernels at every g from 1 to 8 and head_dim 64, and at
head_dim 256, g 10 and 16 and a block of 128 positions, float8_e4m3fn
pages and caches (#5, #7, #9, eager and in a CUDA graph), the f8 write
cast against the CPU's bytes, minicpm-2b's odd-vocabulary tied
unembedding, the contiguous
decode at every group size and head_dim, lengths 0 and past its cache,
and replayed in a CUDA graph (#1-#9, each alone), the engine and the
bucketed server with their steps replayed as CUDA graphs against the same
steps run eagerly, and the Lama primitives (bulk LUT op, signed
histogram) on their vector and scalar paths, with out-of-range codes.
The Lama primitives and the histogram are held to exact equality
(integers, and sums of +-1 in float32).
Tolerance: 1e-4 of the reference's largest magnitude for float outputs
-- float32 on both sides, only the summation order and the library's
exp differ.  uint8 code outputs: at most 1e-3 of the codes may differ,
each by one rounding step (``eq.codes_agree``), since a last-bit float
difference moves a value across a rounding boundary now and then.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import exponential_quant as eq
from repro_torch.kernels.decode_gqa import (decode_gqa_paged,
                                            decode_gqa_paged_codes)
from repro_torch.kernels.decode_gqa.ref import (decode_gqa_paged_codes_ref,
                                                decode_gqa_paged_ref)
from repro_torch.kernels.flash_prefill import (flash_prefill_paged,
                                               flash_prefill_paged_codes)
from repro_torch.kernels.flash_prefill.ref import (
    flash_prefill_paged_codes_ref, flash_prefill_paged_ref)
from repro_torch.kernels.lut_dequant_matmul import (
    lut_dequant_matmul, lut_dequant_matmul_dual, lut_dequant_matmul_dual_gated,
    lut_dequant_matmul_gated)
from repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul import (
    gemm_plan)
from repro_torch.kernels.lut_dequant_matmul.ref import (
    lut_dequant_matmul_dual_gated_ref, lut_dequant_matmul_dual_ref,
    lut_dequant_matmul_gated_ref, lut_dequant_matmul_ref)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _qweight(shape, dev, gen):
    w = torch.randn(shape, generator=gen, device=dev) * 0.05
    codes, p = eq.quantize(w, 7)
    return codes, eq.decode_table(p), eq.pack_qmeta(p)


def _close(out, ref):
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _codes_close(out, ref):
    assert out.dtype == ref.dtype == torch.uint8
    assert bool(eq.codes_agree(out, ref).all())
    assert int((out != ref).sum()) <= 1e-3 * ref.numel()


def _act_codes(shape, dev, gen, scale=1.0):
    """Activation codes of a random tensor under its own fit:
    (codes, lut, qmeta)."""
    x = torch.randn(shape, generator=gen, device=dev) * scale
    p = eq.fit(x, 7)
    return eq.encode(x, p), eq.decode_table(p), eq.pack_qmeta(p)


def _out_qmeta(y):
    """Params fitted on a float result: the out table of a quantize
    epilogue."""
    return eq.pack_qmeta(eq.fit(y, 7))


@pytest.mark.parametrize("m,k,n,trans,mode,epi,bias,xdt", [
    (1, 40, 24, False, "gather", None, False, torch.float32),
    (5, 600, 70, False, "alu", "gelu", True, torch.float32),      # split-K
    (8, 2048, 1000, False, "gather", "silu", False, torch.bfloat16),
    (8, 520, 77, True, "alu", "relu", True, torch.bfloat16),
    (9, 96, 33, False, "gather", "relu", True, torch.float32),    # tiled
    (130, 600, 150, True, "gather", "gelu", False, torch.bfloat16),
    (200, 2048, 64, False, "alu", None, True, torch.float32),     # split-K
])
def test_lut_dequant_matmul_kernel(dev, m, k, n, trans, mode, epi, bias, xdt):
    gen = _gen(dev, m + n)
    x = torch.randn(m, k, generator=gen, device=dev).to(xdt)
    codes, lut, qmeta = _qweight((n, k) if trans else (k, n), dev, gen)
    b = torch.randn(n, generator=gen, device=dev) if bias else None
    out = lut_dequant_matmul(x, codes, lut, qmeta, decode_mode=mode,
                             epilogue=epi, bias=b, transpose_codes=trans,
                             out_dtype=torch.float32)
    ref = lut_dequant_matmul_ref(x, codes, lut, qmeta, epilogue=epi, bias=b,
                                 transpose_codes=trans, decode_mode=mode)
    _close(out, ref)


@pytest.mark.parametrize("m,k,n,mode,act", [
    (3, 600, 70, "gather", "silu"),
    (8, 2048, 6144, "alu", "gelu"),
    (70, 100, 130, "gather", "relu"),
    (256, 2048, 200, "alu", "silu"),
])
def test_lut_dequant_matmul_gated_kernel(dev, m, k, n, mode, act):
    gen = _gen(dev, m)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    cg, lg, qg = _qweight((k, n), dev, gen)
    cu, lu, qu = _qweight((k, n), dev, gen)
    out = lut_dequant_matmul_gated(x, cg, cu, lg, lu, qg, qu, activation=act,
                                   decode_mode=mode, out_dtype=torch.float32)
    ref = lut_dequant_matmul_gated_ref(x, cg, cu, lg, lu, qg, qu,
                                       activation=act, decode_mode=mode)
    _close(out, ref)


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _gated_call(kind, m, k, n, mode, xdt, dev, gen, quant=False):
    """Inputs of #2 (``kind`` "gated": x float32 or bfloat16) or #4
    ("dual_gated": activation codes, u8 out with ``quant``) and
    (kernel call, plain call, float32 plain call) on them."""
    cg, lg, qg = _qweight((k, n), dev, gen)
    cu, lu, qu = _qweight((k, n), dev, gen)
    if kind == "gated":
        x = torch.randn(m, k, generator=gen, device=dev).to(xdt)
        args = (x, cg, cu, lg, lu, qg, qu)
        call = lambda: lut_dequant_matmul_gated(
            *args, decode_mode=mode, out_dtype=torch.float32)
        ref = lambda: lut_dequant_matmul_gated_ref(*args, decode_mode=mode)
        return x, call, ref, ref
    xc, lx, qx = _act_codes((m, k), dev, gen)
    args = (xc, cg, cu, lx, lg, lu, qx, qg, qu)
    ref_f = lambda: lut_dequant_matmul_dual_gated_ref(*args, decode_mode=mode)
    qo = _out_qmeta(ref_f()) if quant else None
    call = lambda: lut_dequant_matmul_dual_gated(*args, out_qmeta=qo,
                                                 decode_mode=mode)
    ref = lambda: lut_dequant_matmul_dual_gated_ref(*args, out_qmeta=qo,
                                                    decode_mode=mode)
    return xc, call, ref, ref_f


# the redesigned gated paths' edges: M at and around the decode limit
# (8) and the 128-row tile, K off the 32-row stage, N off the 16-byte
# row and the 64- and 128-column blocks (rows staged byte by byte), both
# decode modes, float32 and bfloat16 x (#2), float and u8 out (#4)
GATED_EDGES = [
    (1, 600, 70, "gather", torch.float32),
    (8, 100, 130, "alu", torch.bfloat16),
    (8, 2048, 256, "alu", torch.float32),        # a cluster of 8
    (9, 600, 200, "gather", torch.bfloat16),
    (127, 100, 70, "alu", torch.float32),
    (129, 600, 130, "gather", torch.float32),
    (256, 100, 200, "alu", torch.bfloat16),
    (256, 2048, 6144, "gather", torch.bfloat16),  # an engine tail chunk
]


@pytest.mark.parametrize("kind", ["gated", "dual_gated"])
@pytest.mark.parametrize("m,k,n,mode,xdt", GATED_EDGES)
def test_gated_kernels_at_the_path_edges(dev, kind, m, k, n, mode, xdt):
    quant = (m + k) % 2 == 1
    gen = _gen(dev, m * 3 + k + n)
    _, call, ref, _ = _gated_call(kind, m, k, n, mode, xdt, dev, gen, quant)
    out = call()
    if kind == "dual_gated" and quant:
        _codes_close(out, ref())
    else:
        _close(out, ref())


@pytest.mark.parametrize("kind", ["gated", "dual_gated"])
@pytest.mark.parametrize("m", [8, 200])
def test_gated_kernels_take_rows_off_16_byte_boundaries(dev, kind, m):
    """x and the codes starting 4 and 1 bytes past an alignment (views
    into larger tensors): staged byte by byte, same result."""
    gen = _gen(dev, 90 + m)
    k, n = 512, 192
    cg, lg, qg = _qweight((k, n), dev, gen)
    cu, lu, qu = _qweight((k, n), dev, gen)
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    cg2, cu2 = shift(cg), shift(cu)
    assert cg2.data_ptr() % 16 and cg2.is_contiguous()
    if kind == "gated":
        x = shift(torch.randn(m, k, generator=gen, device=dev))
        assert x.data_ptr() % 16
        out = lut_dequant_matmul_gated(x, cg2, cu2, lg, lu, qg, qu,
                                       out_dtype=torch.float32)
        _close(out, lut_dequant_matmul_gated_ref(x, cg, cu, lg, lu, qg, qu))
    else:
        xc, lx, qx = _act_codes((m, k), dev, gen)
        xc2 = shift(xc)
        out = lut_dequant_matmul_dual_gated(xc2, cg2, cu2, lx, lg, lu, qx, qg, qu)
        _close(out, lut_dequant_matmul_dual_gated_ref(xc, cg, cu, lx, lg, lu,
                                                      qx, qg, qu))


@pytest.mark.parametrize("m,k,n", [(5, 2048, 256), (129, 2048, 200)])
def test_gated_split_encodes_once_after_the_reduce(dev, m, k, n):
    """#4 with an out qmeta where K is split: over a cluster at M <= 8
    (each rank encodes its columns' summed partials) and over blocks with a
    reduce pass at M > 8; an encode per split would disagree."""
    assert gemm_plan(m, k, n, _sms(), 2)[0] > 1
    gen = _gen(dev, 13 + m)
    _, call, ref, ref_f = _gated_call("dual_gated", m, k, n, "gather", None,
                                      dev, gen, quant=True)
    out = call()
    _codes_close(out, ref())
    qo = _out_qmeta(ref_f())
    assert bool((eq.codes_agree(out, eq.encode_meta(ref_f(), qo))).all())


@pytest.mark.parametrize("kind", ["gated", "dual_gated"])
def test_gated_decode_replays_in_a_cuda_graph(dev, kind):
    """The cluster plan is sized from shapes alone: a decode-shaped call
    captured in a CUDA graph and replayed after new x is written into
    the captured tensor equals the plain version on that x."""
    gen = _gen(dev, 55)
    m, k, n = 8, 1024, 512
    assert gemm_plan(m, k, n, _sms(), 2)[0] > 1
    x, call, ref, _ = _gated_call(kind, m, k, n, "gather", torch.bfloat16,
                                  dev, gen, quant=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # build, load, warm up
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for seed in (1, 2, 3):
        g2 = _gen(dev, seed)
        if kind == "gated":
            x.copy_(torch.randn(m, k, generator=g2, device=dev))
        else:
            x.copy_(torch.randint(0, 256, (m, k), generator=g2, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        if kind == "gated":
            _close(out, ref())
        else:
            _codes_close(out, ref())


def _plain_call(kind, m, k, n, mode, xdt, dev, gen, quant=False,
                transposed=False):
    """Inputs of #1 (``kind`` "plain": x float32 or bfloat16, bias,
    gelu; codes [N, K] when ``transposed``) or #3 ("dual": activation
    codes, bias, silu, u8 out with ``quant``) and (x, kernel call, plain
    call) on them."""
    codes, lut, qmeta = _qweight((n, k) if transposed else (k, n), dev, gen)
    b = torch.randn(n, generator=gen, device=dev)
    if kind == "plain":
        x = torch.randn(m, k, generator=gen, device=dev).to(xdt)
        kw = dict(decode_mode=mode, epilogue="gelu", bias=b,
                  transpose_codes=transposed)
        call = lambda: lut_dequant_matmul(x, codes, lut, qmeta,
                                          out_dtype=torch.float32, **kw)
        ref = lambda: lut_dequant_matmul_ref(x, codes, lut, qmeta, **kw)
        return x, call, ref
    xc, lx, qx = _act_codes((m, k), dev, gen)
    args = (xc, codes, lx, lut, qx, qmeta)
    kw = dict(decode_mode=mode, epilogue="silu", bias=b)
    qo = _out_qmeta(lut_dequant_matmul_dual_ref(*args, **kw)) if quant else None
    call = lambda: lut_dequant_matmul_dual(*args, out_qmeta=qo, **kw)
    ref = lambda: lut_dequant_matmul_dual_ref(*args, out_qmeta=qo, **kw)
    return xc, call, ref


# the redesigned plain and dual paths' edges (#1/#3 on the one-weight
# bodies): M at the decode limit (8) and past it (9, 256), K off the
# 32-row stage, N off the 16-byte row and the 128-column blocks (rows
# staged byte by byte), both decode modes, float32 and bfloat16 x (#1),
# float and u8 out (#3)
PLAIN_EDGES = [
    (8, 100, 70, "gather", torch.float32),
    (8, 600, 130, "alu", torch.bfloat16),
    (8, 2048, 200, "gather", torch.bfloat16),     # a cluster of 8
    (9, 600, 200, "alu", torch.float32),
    (9, 100, 130, "gather", torch.bfloat16),
    (256, 100, 70, "gather", torch.bfloat16),
    (256, 600, 130, "alu", torch.float32),
    (256, 2048, 2048, "gather", torch.bfloat16),  # an engine tail chunk
]


@pytest.mark.parametrize("kind", ["plain", "dual"])
@pytest.mark.parametrize("m,k,n,mode,xdt", PLAIN_EDGES)
def test_plain_and_dual_kernels_at_the_path_edges(dev, kind, m, k, n, mode,
                                                  xdt):
    quant = (m + k) % 2 == 0
    gen = _gen(dev, m * 5 + k + n)
    _, call, ref = _plain_call(kind, m, k, n, mode, xdt, dev, gen, quant)
    out = call()
    if kind == "dual" and quant:
        _codes_close(out, ref())
    else:
        _close(out, ref())


@pytest.mark.parametrize("kind", ["plain", "dual"])
@pytest.mark.parametrize("m", [8, 200])
def test_plain_and_dual_kernels_take_rows_off_16_byte_boundaries(dev, kind, m):
    """x and the codes starting 4 and 1 bytes past an alignment (views
    into larger tensors): staged byte by byte, same result."""
    gen = _gen(dev, 70 + m)
    k, n = 512, 192
    codes, lut, qmeta = _qweight((k, n), dev, gen)
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    codes2 = shift(codes)
    assert codes2.data_ptr() % 16 and codes2.is_contiguous()
    if kind == "plain":
        x = shift(torch.randn(m, k, generator=gen, device=dev))
        assert x.data_ptr() % 16
        out = lut_dequant_matmul(x, codes2, lut, qmeta, epilogue="relu")
        _close(out, lut_dequant_matmul_ref(x, codes, lut, qmeta,
                                           epilogue="relu"))
    else:
        xc, lx, qx = _act_codes((m, k), dev, gen)
        out = lut_dequant_matmul_dual(shift(xc), codes2, lx, lut, qx, qmeta)
        _close(out, lut_dequant_matmul_dual_ref(xc, codes, lx, lut, qx, qmeta))


@pytest.mark.parametrize("m,k,n,mode,xdt,off", [
    (8, 2048, 151936, "gather", torch.bfloat16, False),  # the unembedding
    (1, 2048, 200, "alu", torch.float32, False),         # N off the block
    (5, 600, 77, "gather", torch.bfloat16, False),       # K off the step
    (8, 100, 130, "alu", torch.float32, False),          # K off 16 bytes
    (8, 512, 300, "gather", torch.bfloat16, True),       # rows off 16 B
    (3, 4100, 64, "gather", torch.float32, False),       # three x chunks
])
def test_transposed_decode_kernel(dev, m, k, n, mode, xdt, off):
    """The tied unembedding at M <= 8 (codes [N, K], streamed): N ragged
    to the 128-column block, K ragged to the 64-k step and to 16 bytes,
    more than one staged x chunk, codes and x off their alignment, and
    the full vocabulary."""
    gen = _gen(dev, 31 + n)
    codes, lut, qmeta = _qweight((n, k), dev, gen)
    x = torch.randn(m, k, generator=gen, device=dev).to(xdt)
    b = torch.randn(n, generator=gen, device=dev)
    if off:
        shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
        codes, x = shift(codes), shift(x)
        assert codes.data_ptr() % 16 and x.data_ptr() % 16
    kw = dict(decode_mode=mode, epilogue="silu", bias=b, transpose_codes=True)
    out = lut_dequant_matmul(x, codes, lut, qmeta, out_dtype=torch.float32, **kw)
    _close(out, lut_dequant_matmul_ref(x, codes, lut, qmeta, **kw))


@pytest.mark.parametrize("m,k,n,mode,xdt,off", [
    (9, 600, 200, "gather", torch.bfloat16, False),
    (256, 100, 70, "alu", torch.float32, False),       # K off 16 bytes
    (200, 2048, 64, "gather", torch.bfloat16, False),  # split-K
    (130, 512, 130, "alu", torch.bfloat16, True),      # rows off 16 B
])
def test_transposed_prefill_kernel(dev, m, k, n, mode, xdt, off):
    """The tied unembedding at M > 8 (codes [N, K] staged transposed in
    the one-weight prefill tile): ragged M, K and N, split-K, codes and x
    off their alignment."""
    gen = _gen(dev, 41 + m)
    codes, lut, qmeta = _qweight((n, k), dev, gen)
    x = torch.randn(m, k, generator=gen, device=dev).to(xdt)
    b = torch.randn(n, generator=gen, device=dev)
    if off:
        shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
        codes, x = shift(codes), shift(x)
        assert codes.data_ptr() % 16 and x.data_ptr() % 16
    kw = dict(decode_mode=mode, epilogue="gelu", bias=b, transpose_codes=True)
    out = lut_dequant_matmul(x, codes, lut, qmeta, out_dtype=torch.float32, **kw)
    _close(out, lut_dequant_matmul_ref(x, codes, lut, qmeta, **kw))


@pytest.mark.parametrize("kind,transposed", [("plain", False), ("dual", False),
                                             ("plain", True)])
def test_plain_decode_replays_in_a_cuda_graph(dev, kind, transposed):
    """#1 and #3 at decode (a cluster plan) and the tied unembedding are
    sized from shapes alone: a call captured in a CUDA graph and replayed
    after new x is written into the captured tensor equals the plain
    version on that x."""
    gen = _gen(dev, 57)
    m, k, n = 8, 1024, 512
    assert transposed or gemm_plan(m, k, n, _sms(), 1)[0] > 1
    x, call, ref = _plain_call(kind, m, k, n, "gather", torch.bfloat16, dev,
                               gen, quant=True, transposed=transposed)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # build, load, warm up
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for seed in (1, 2, 3):
        g2 = _gen(dev, seed)
        if kind == "plain":
            x.copy_(torch.randn(m, k, generator=g2, device=dev))
        else:
            x.copy_(torch.randint(0, 256, (m, k), generator=g2, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        if kind == "plain":
            _close(out, ref())
        else:
            _codes_close(out, ref())


def _pages(dev, gen, b, n_kv, bs, max_blk, dtype, hd=128):
    n = 1 + b * max_blk
    kp = torch.randn(n, bs, n_kv, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n, bs, n_kv, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device=dev)[: b * max_blk] + 1
    return kp, vp, perm.reshape(b, max_blk).to(torch.int32).contiguous()


def _prefill_rows(dev, bs, s, long):
    """(max_blk, q_start, kv_lens) of the prefill tests' four rows: row 0
    a cold start, or with ``long`` the last chunk of a 4096-position row
    (max_blk 256); rows 1 and 2 start off a page boundary (row 1 ends
    mid-chunk); row 3 has nothing to do."""
    max_blk = 4096 // bs if long else max(8, -(-(bs + 1 + s) // bs))
    q_start = torch.tensor([max_blk * bs - s if long else 0, 3, bs + 1, 0],
                           dtype=torch.int32, device=dev)
    valid = torch.tensor([s, s // 2, s, 0], dtype=torch.int32, device=dev)
    kv_lens = torch.where(valid > 0, q_start + valid, 0).to(torch.int32)
    return max_blk, q_start, kv_lens


# S below one query tile (64 rows) and not a multiple of it; KV tiles of
# 32 positions spanning pages and ending mid-page; every q/page dtype
# pair; one 4096-position row
@pytest.mark.parametrize("g,bs,s,qdt,pdt,long", [
    (2, 16, 37, torch.float32, torch.float32, False),
    (1, 8, 5, torch.float32, torch.bfloat16, False),
    (4, 32, 64, torch.float32, torch.float32, False),
    (2, 48, 20, torch.float32, torch.bfloat16, False),
    (1, 64, 1, torch.bfloat16, torch.float32, False),
    (8, 8, 16, torch.bfloat16, torch.bfloat16, False),
    (2, 64, 256, torch.bfloat16, torch.float32, False),
    (4, 16, 256, torch.bfloat16, torch.bfloat16, False),
    (8, 48, 37, torch.float32, torch.float32, False),
    (2, 16, 64, torch.float32, torch.bfloat16, False),
    (2, 16, 256, torch.bfloat16, torch.float32, True),
])
def test_flash_prefill_paged_kernel(dev, g, bs, s, qdt, pdt, long):
    gen = _gen(dev, g * 100 + bs)
    b, n_kv = 4, 2
    max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, long)
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, pdt)
    q = torch.randn(b, s, n_kv, g, 128, generator=gen, device=dev).to(qdt)
    out = flash_prefill_paged(q, kp, vp, bt, q_start, kv_lens)
    ref = flash_prefill_paged_ref(q, kp, vp, bt, q_start, kv_lens)
    _close(out, ref)
    assert torch.all(out[3] == 0)


def _decode_rows(dev, bs, long):
    """(max_blk, lengths) of the paged decode tests' five rows: lengths
    1 and 0, one ending mid-page, one filling the table and one at 50;
    with ``long`` a 4096-position table (max_blk 4096 / bs: many
    partitions, the fourth row filling it, the fifth at 2000)."""
    max_blk = 4096 // bs if long else 6
    lengths = torch.tensor([1, 0, 17, max_blk * bs, 2000 if long else 50],
                           dtype=torch.int32, device=dev)
    return max_blk, lengths


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,long", [(16, False), (64, False), (16, True)])
def test_decode_gqa_paged_kernel(dev, g, pdt, bs, long):
    gen = _gen(dev, g + bs - 16 + 1000 * long)
    b, n_kv = 5, 2
    max_blk, lengths = _decode_rows(dev, bs, long)
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, pdt)
    q = torch.randn(b, n_kv, g, 128, generator=gen, device=dev).to(torch.bfloat16)
    out = decode_gqa_paged(q, kp, vp, bt, lengths)
    ref = decode_gqa_paged_ref(q, kp, vp, bt, lengths)
    _close(out, ref)
    assert torch.all(out[1] == 0)


def test_decode_gqa_paged_replays_in_a_cuda_graph(dev):
    """The split grid is sized from shapes alone: a step captured in a
    CUDA graph and replayed after new lengths are written into the
    captured tensor equals the plain version on those lengths."""
    gen = _gen(dev, 77)
    b, n_kv, g, bs, max_blk = 4, 2, 2, 16, 64
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32)
    q = torch.randn(b, n_kv, g, 128, generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([5, 0, 300, 1024], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # build, load, warm up
        decode_gqa_paged(q, kp, vp, bt, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_gqa_paged(q, kp, vp, bt, lengths)
    for new in ([1024, 7, 0, 65], [0, 0, 0, 0], [17, 732, 400, 1]):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, decode_gqa_paged_ref(q, kp, vp, bt, lengths))
        assert torch.all(out[lengths == 0] == 0)


@pytest.mark.parametrize("bs,max_blk", [(64, 1), (16, 64)])  # 1 and 16 partitions
def test_decode_gqa_paged_kernels_clip_the_lengths(dev, bs, max_blk):
    """The wrappers hand the card's lengths to the kernels as they are:
    lengths below 0 or past max_blk * bs give what the plain versions
    give on lengths clipped to [0, max_blk * bs]."""
    gen = _gen(dev, 90 + max_blk)
    b, n_kv, g = 4, 2, 2
    top = max_blk * bs
    lengths = torch.tensor([-3, top + 5, 1 << 30, 17], dtype=torch.int32,
                           device=dev)
    clipped = lengths.clamp(0, top)
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32)
    q = torch.randn(b, n_kv, g, 128, generator=gen, device=dev)
    out = decode_gqa_paged(q, kp, vp, bt, lengths)
    _close(out, decode_gqa_paged_ref(q, kp, vp, bt, clipped))
    assert torch.all(out[0] == 0)
    kc, vc, bt, kl, vl = _code_pages(dev, gen, b, n_kv, bs, max_blk)
    qc, ql, _ = _act_codes((b, n_kv, g, 128), dev, gen)
    oq = torch.tensor([0.02, 1e-4, 1.04, 7.0], device=dev)
    args = (qc, kc, vc, ql, kl, vl, oq, bt)
    _codes_close(decode_gqa_paged_codes(*args, lengths),
                 decode_gqa_paged_codes_ref(*args, clipped))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    gen = _gen(dev, 0)
    codes, lut, _ = _qweight((64, 32), dev, gen)
    x = torch.randn(4, 128, generator=gen, device=dev)
    with pytest.raises(ValueError):           # K mismatch
        lut_dequant_matmul(x, codes, lut)
    with pytest.raises(ValueError):           # non-contiguous x
        lut_dequant_matmul(x[:, ::2], codes, lut)
    with pytest.raises(TypeError):            # x dtype
        lut_dequant_matmul(x[:, :64].to(torch.float16), codes, lut)
    kp, vp, bt = _pages(dev, gen, 2, 2, 16, 4, torch.float32, hd=96)
    q = torch.randn(2, 2, 2, 96, generator=gen, device=dev)
    lengths = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):     # head_dim 96
        decode_gqa_paged(q, kp, vp, bt, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill_paged(q[:, None], kp, vp, bt, 0, 3)
    kp, vp, bt = _pages(dev, gen, 2, 2, 16, 4, torch.float32)
    q17 = torch.randn(2, 2, 17, 128, generator=gen, device=dev)
    with pytest.raises(ValueError, match="g=17"):         # g 17
        decode_gqa_paged(q17, kp, vp, bt, lengths)
    with pytest.raises(ValueError, match="g=17"):
        flash_prefill_paged(q17[:, None], kp, vp, bt, 0, 3)
    from repro_torch.kernels.decode_gqa import decode_gqa
    kc = torch.randn(2, 16, 2, 128, generator=gen, device=dev)
    with pytest.raises(ValueError, match="g=17"):
        decode_gqa(q17, kc, kc, lengths)
    f8 = torch.float8_e4m3fn
    q2 = q17[:, :, :2].contiguous()
    with pytest.raises(TypeError, match="q dtype"):       # f8 queries
        decode_gqa_paged(q2.to(f8), kp.to(f8), vp.to(f8), bt, lengths)
    # 2 x 65536 positions of 65536-position pages: past the prefill
    # kernel's exact division (positions x bs <= 2^32)
    kw = torch.zeros(1, 1 << 16, 2, 128, dtype=f8, device=dev)
    btw = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="2\\^32"):
        flash_prefill_paged(q2[:, None], kw, kw, btw, 0, 3)
    qp = torch.randn(2 * 3 * 2 * 2 * 128 + 1, generator=gen, device=dev)
    qp = qp[1:].view(2, 3, 2, 2, 128)         # 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        flash_prefill_paged(qp, kp, vp, bt, 0, 3)


def test_launch_counters_count_kernel_launches(dev):
    from repro_torch.kernels import _build

    gen = _gen(dev, 1)
    codes, lut, _ = _qweight((64, 32), dev, gen)
    x = torch.randn(4, 64, generator=gen, device=dev)
    before = _build.launch_counts().get("lut_dequant_matmul", 0)
    lut_dequant_matmul(x, codes, lut)
    lut_dequant_matmul(x.cpu(), codes.cpu(), lut.cpu())    # plain version
    assert _build.launch_counts()["lut_dequant_matmul"] == before + 1


def test_small_engine_on_the_card_matches_the_cpu(dev):
    """A 2-layer, head_dim-128 decoder with 7-bit codes, served on the
    card and on the CPU from the same weights: equal token streams."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    cfg = get_config("qwen3-1.7b").replace(
        num_layers=2, d_model=256, num_heads=2, num_kv_heads=1, head_dim=128,
        d_ff=512, vocab_size=1024, compute_dtype="float32")
    ec = EngineConfig(num_slots=3, block_size=16, max_seq_len=96,
                      prefill_chunk=32)
    card = Engine(cfg, quant_bits=7, engine=ec, device="cuda", rng_seed=3)
    cpu = Engine(cfg, params=copy.deepcopy(card.params).to("cpu"), engine=ec,
                 device="cpu")
    rng = np.random.default_rng(0)
    reqs = lambda: [Request(i, rng_p, 10) for i, rng_p in enumerate(prompts)]
    prompts = [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 70, 17)]
    a, b = card.generate(reqs()), cpu.generate(reqs())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)


@pytest.mark.parametrize("m,k,n,mode,epi,bias,quant", [
    (1, 40, 1024, "gather", None, False, True),
    (5, 2048, 256, "alu", "gelu", True, True),       # split-K + encode
    (8, 520, 777, "gather", "silu", True, False),
    (33, 100, 48, "alu", "relu", False, True),       # tiled, ragged K
    (130, 600, 150, "gather", None, True, True),
    (200, 2048, 64, "gather", "gelu", False, False),  # tiled split-K
])
def test_lut_dequant_matmul_dual_kernel(dev, m, k, n, mode, epi, bias, quant):
    gen = _gen(dev, 7 * m + n)
    xc, lx, qx = _act_codes((m, k), dev, gen)
    codes, lut, qmeta = _qweight((k, n), dev, gen)
    b = torch.randn(n, generator=gen, device=dev) if bias else None
    args = (xc, codes, lx, lut, qx, qmeta)
    kw = dict(decode_mode=mode, epilogue=epi, bias=b)
    ref_f = lut_dequant_matmul_dual_ref(*args, **kw)
    qo = _out_qmeta(ref_f) if quant else None
    out = lut_dequant_matmul_dual(*args, out_qmeta=qo, **kw)
    if quant:
        _codes_close(out, lut_dequant_matmul_dual_ref(*args, out_qmeta=qo, **kw))
    else:
        _close(out, ref_f)


def test_dual_split_k_encodes_once_after_the_reduce(dev):
    """Split-K with an out qmeta: each rank of the cluster encodes, for
    its columns, the ranks' summed partials (an encode per split would
    disagree)."""
    m, k, n = 5, 2048, 256
    assert gemm_plan(m, k, n, _sms(), 1)[0] > 1
    gen = _gen(dev, 11)
    xc, lx, qx = _act_codes((m, k), dev, gen)
    codes, lut, qmeta = _qweight((k, n), dev, gen)
    ref_f = lut_dequant_matmul_dual_ref(xc, codes, lx, lut, qx, qmeta)
    qo = _out_qmeta(ref_f)
    out = lut_dequant_matmul_dual(xc, codes, lx, lut, qx, qmeta, out_qmeta=qo)
    _codes_close(out, eq.encode_meta(ref_f, qo))


@pytest.mark.parametrize("m,k,n,mode,act,quant", [
    (3, 600, 700, "gather", "silu", True),
    (8, 2048, 6144, "alu", "gelu", True),
    (70, 100, 130, "gather", "relu", False),
    (256, 2048, 200, "alu", "silu", True),
])
def test_lut_dequant_matmul_dual_gated_kernel(dev, m, k, n, mode, act, quant):
    gen = _gen(dev, m + 3)
    xc, lx, qx = _act_codes((m, k), dev, gen)
    cg, lg, qg = _qweight((k, n), dev, gen)
    cu, lu, qu = _qweight((k, n), dev, gen)
    args = (xc, cg, cu, lx, lg, lu, qx, qg, qu)
    kw = dict(activation=act, decode_mode=mode)
    ref_f = lut_dequant_matmul_dual_gated_ref(*args, **kw)
    qo = _out_qmeta(ref_f) if quant else None
    out = lut_dequant_matmul_dual_gated(*args, out_qmeta=qo, **kw)
    if quant:
        _codes_close(out, lut_dequant_matmul_dual_gated_ref(
            *args, out_qmeta=qo, **kw))
    else:
        _close(out, ref_f)


def _code_pages(dev, gen, b, n_kv, bs, max_blk, hd=128):
    """uint8 code pages with per-head tables: (kp, vp, bt, k_lut, v_lut)."""
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32, hd)
    out = [bt]
    for p in (kp, vp):
        rows = p.permute(2, 0, 1, 3).reshape(n_kv, -1)
        fit = eq.fit(rows, 7, stacked=True)
        qm = eq.pack_qmeta(fit)
        out += [eq.encode_meta(p, qm[:, None, :]), eq.decode_table(fit)]
    bt, kc, kl, vc, vl = out
    return kc, vc, bt, kl, vl


@pytest.mark.parametrize("g,bs,s,long", [
    (1, 8, 5, False), (2, 16, 37, False), (4, 32, 64, False),
    (8, 48, 20, False), (1, 64, 1, False), (8, 8, 16, False),
    (2, 64, 256, False), (4, 16, 256, False), (2, 16, 256, True),
])
def test_flash_prefill_paged_codes_kernel(dev, g, bs, s, long):
    gen = _gen(dev, 300 + g * 10 + bs)
    b, n_kv = 4, 2
    max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, long)
    kc, vc, bt, kl, vl = _code_pages(dev, gen, b, n_kv, bs, max_blk)
    qc, ql, _ = _act_codes((b, s, n_kv, g, 128), dev, gen)
    oq = torch.tensor([0.02, 1e-4, 1.04, 7.0], device=dev)
    args = (qc, kc, vc, ql, kl, vl, oq, bt, q_start, kv_lens)
    out = flash_prefill_paged_codes(*args)
    _codes_close(out, flash_prefill_paged_codes_ref(*args))
    assert torch.all(out[3] == eq.encode_meta(torch.zeros((), device=dev), oq))


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("bs,long", [(16, False), (48, False), (64, False),
                                     (16, True)])
def test_decode_gqa_paged_codes_kernel(dev, g, bs, long):
    gen = _gen(dev, 500 + g + bs + 1000 * long)
    b, n_kv = 5, 2
    max_blk, lengths = _decode_rows(dev, bs, long)
    kc, vc, bt, kl, vl = _code_pages(dev, gen, b, n_kv, bs, max_blk)
    qc, ql, _ = _act_codes((b, n_kv, g, 128), dev, gen)
    oq = torch.tensor([0.02, 1e-4, 1.04, 7.0], device=dev)
    args = (qc, kc, vc, ql, kl, vl, oq, bt, lengths)
    out = decode_gqa_paged_codes(*args)
    _codes_close(out, decode_gqa_paged_codes_ref(*args))
    assert torch.all(out[1] == eq.encode_meta(torch.zeros((), device=dev), oq))


def test_small_codes_engine_on_the_card_matches_the_cpu(dev, tmp_path,
                                                        monkeypatch):
    """Activations and KV pages as codes: a 2-layer, head_dim-128 decoder
    calibrated on the card, then served on the card and on the CPU from
    the same weights and tables -- equal token streams."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    cfg = get_config("qwen3-1.7b").replace(
        num_layers=2, d_model=256, num_heads=2, num_kv_heads=1, head_dim=128,
        d_ff=512, vocab_size=1024, compute_dtype="float32")
    ec = EngineConfig(num_slots=3, block_size=16, max_seq_len=96,
                      prefill_chunk=32)
    card = Engine(cfg, quant_bits=7, act_quant=7, kv_codes=True, engine=ec,
                  device="cuda", rng_seed=3)
    assert card.cache.k_pages.dtype == torch.uint8
    cpu = Engine(cfg, params=copy.deepcopy(card.params).to("cpu"), engine=ec,
                 kv_codes=True, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 70, 17)]
    reqs = lambda: [Request(i, p, 10) for i, p in enumerate(prompts)]
    a, b = card.generate(reqs()), cpu.generate(reqs())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("kdt", [torch.float32, torch.bfloat16])
def test_decode_gqa_contiguous_kernel(dev, g, hd, kdt):
    """#9 on the split-KV body: S = 200 (3 virtual pages of 64 and a
    tail of 8), lengths 1, 0, 64, past S (clipped to S on the card) and
    -3 (clipped to 0), and one mid-row."""
    from repro_torch.kernels.decode_gqa import decode_gqa
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_ref

    gen = _gen(dev, 700 + g + hd)
    b, s, n_kv = 6, 200, 2
    q = torch.randn(b, n_kv, g, hd, generator=gen, device=dev)
    q = q.to(torch.bfloat16) if g % 2 else q
    k = torch.randn(b, s, n_kv, hd, generator=gen, device=dev).to(kdt)
    v = torch.randn(b, s, n_kv, hd, generator=gen, device=dev).to(kdt)
    lengths = torch.tensor([1, 0, 64, s + 60, -3, 131], dtype=torch.int32,
                           device=dev)
    out = decode_gqa(q, k, v, lengths)
    ref = decode_gqa_ref(q, k, v, lengths.clamp(0, s))
    _close(out, ref)
    assert torch.all(out[1] == 0) and torch.all(out[4] == 0)
    k2, v2 = k.clone(), v.clone()               # past lengths: no effect
    k2[0, 1:], v2[0, 1:] = 1e4, -1e4
    assert torch.equal(decode_gqa(q, k2, v2, lengths)[0], out[0])


def test_decode_gqa_contiguous_replays_in_a_cuda_graph(dev):
    """#9's split grid is sized from shapes alone and the wrapper
    launches no clamp: a call captured in a CUDA graph and replayed after
    new lengths are written into the captured tensor equals the plain
    version on those lengths (clipped to [0, S])."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_gqa import decode_gqa
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_ref

    gen = _gen(dev, 78)
    b, s, n_kv, g = 4, 768, 8, 2
    q = torch.randn(b, n_kv, g, 128, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, n_kv, 128, generator=gen, device=dev)
    v = torch.randn(b, s, n_kv, 128, generator=gen, device=dev)
    lengths = torch.tensor([5, 0, 300, 768], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # build, load, warm up
        decode_gqa(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.launch_counts().get("decode_gqa", 0)
    with torch.cuda.graph(graph):
        out = decode_gqa(q, k, v, lengths)
    assert _build.launch_counts()["decode_gqa"] == before + 1
    for new in ([768, 7, 0, 65], [0, 0, 0, 0], [17, 900, 400, -1]):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        clipped = lengths.clamp(0, s)
        _close(out, decode_gqa_ref(q, k, v, clipped))
        assert torch.all(out[clipped == 0] == 0)


# the head layouts beyond qwen3-1.7b's: every g from 1 to 8 at head_dim
# 128 (g 3, 5, 6, 7 run the next power of two's instantiation, and pad
# the prefill blocks' rows) and at head_dim 64
LAYOUTS = [(3, 128), (5, 128), (6, 128), (7, 128),
           (1, 64), (2, 64), (3, 64), (5, 64), (8, 64)]


@pytest.mark.parametrize("g,hd", LAYOUTS)
@pytest.mark.parametrize("kernel", ["prefill", "prefill_codes", "decode",
                                    "decode_codes"])
def test_paged_attention_kernels_at_other_head_layouts(dev, kernel, g, hd):
    """#5-#8 at g 3-8 and head_dim 64: prefill over rows that start off a
    page and a 4096-position table's last chunk would repeat the other
    tests; here the prefill rows of ``_prefill_rows`` (S = 37, bs 16)
    and the decode rows of ``_decode_rows`` (bs 16, 6 pages)."""
    gen = _gen(dev, 900 + g * 10 + hd)
    b, n_kv, bs = 4, 2, 16
    oq = torch.tensor([0.02, 1e-4, 1.04, 7.0], device=dev)
    if kernel.startswith("prefill"):
        s = 37
        max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, False)
        shape = (b, s, n_kv, g, hd)
    else:
        b = 5
        max_blk, lengths = _decode_rows(dev, bs, False)
        shape = (b, n_kv, g, hd)
    if kernel.endswith("codes"):
        kc, vc, bt, kl, vl = _code_pages(dev, gen, b, n_kv, bs, max_blk, hd)
        qc, ql, _ = _act_codes(shape, dev, gen)
        args = (qc, kc, vc, ql, kl, vl, oq, bt)
        if kernel == "prefill_codes":
            args += (q_start, kv_lens)
            _codes_close(flash_prefill_paged_codes(*args),
                         flash_prefill_paged_codes_ref(*args))
        else:
            args += (lengths,)
            _codes_close(decode_gqa_paged_codes(*args),
                         decode_gqa_paged_codes_ref(*args))
        return
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32, hd)
    q = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    if kernel == "prefill":
        args = (q, kp, vp, bt, q_start, kv_lens)
        out = flash_prefill_paged(*args)
        _close(out, flash_prefill_paged_ref(*args))
        assert torch.all(out[3] == 0)
    else:
        out = decode_gqa_paged(q, kp, vp, bt, lengths)
        _close(out, decode_gqa_paged_ref(q, kp, vp, bt, lengths))
        assert torch.all(out[1] == 0)


@pytest.mark.parametrize("g,m,bdt,bits,tdt", [
    (4, 8192 + 16, torch.uint8, 8, torch.int32),    # vector path, 3 spans
    (3, 37, torch.uint8, 8, torch.int32),           # scalar path
    (5, 4100, torch.int32, 6, torch.int32),         # int32 codes, vector
    (2, 33, torch.int32, 5, torch.float32),         # float table, scalar
])
def test_lama_bulk_op_kernel(dev, g, m, bdt, bits, tdt):
    from repro_torch.core.lut import mul_lut
    from repro_torch.kernels.lama_bulk_op import lama_bulk_op
    from repro_torch.kernels.lama_bulk_op.ref import lama_bulk_op_ref

    gen = _gen(dev, g * m)
    a = torch.randint(0, 2 ** bits, (g,), generator=gen, device=dev)
    b = torch.randint(0, 2 ** bits, (g, m), generator=gen, device=dev).to(bdt)
    table = mul_lut(bits, device=dev).to(tdt)
    out = lama_bulk_op(a, b, table)
    assert out.dtype == tdt
    assert torch.equal(out, lama_bulk_op_ref(a, b, table))


def test_lama_bulk_op_kernel_raises_on_codes_outside_the_table(dev):
    from repro_torch.core.lut import mul_lut
    from repro_torch.kernels.lama_bulk_op import lama_bulk_op

    table = mul_lut(4, device=dev)
    a = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    b = torch.ones(2, 64, dtype=torch.uint8, device=dev)
    lama_bulk_op(a, b, table)
    for a_bad, b_bad in ((a + 15, b), (a, b * 16), (a - 2, b)):
        with pytest.raises(ValueError, match="outside the table"):
            lama_bulk_op(a_bad, b_bad, table)


@pytest.mark.parametrize("g,m,bins", [(3, 2048, 127), (5, 37, 16),
                                      (2, 1000, 512), (64, 96, 255)])
def test_exp_histogram_kernel(dev, g, m, bins):
    from repro_torch.kernels.exp_histogram import exp_histogram
    from repro_torch.kernels.exp_histogram.ref import exp_histogram_ref

    gen = _gen(dev, g + m)
    # a few values outside [0, bins) count nowhere, as in the one-hot
    vals = torch.randint(-2, bins + 2, (g, m), generator=gen, device=dev,
                         dtype=torch.int32)
    signs = torch.randint(0, 2, (g, m), generator=gen, device=dev) * 2.0 - 1.0
    out = exp_histogram(vals, signs, bins)
    assert torch.equal(out, exp_histogram_ref(vals, signs, bins))
    with pytest.raises(ValueError):
        exp_histogram(vals, signs, 513)


def test_lama_primitives_on_the_card_match_the_cpu(dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.exp_histogram import term1_counts
    from repro_torch.kernels.lama_bulk_op import lama_vector_matrix

    gen = _gen(dev, 9)
    v = torch.randint(0, 256, (300,), generator=gen, device=dev)
    m = torch.randint(0, 256, (300, 500), generator=gen, device=dev,
                      dtype=torch.int32)
    before = _build.launch_counts()
    out = lama_vector_matrix(v, m, 8)
    assert torch.equal(out.cpu(), lama_vector_matrix(v.cpu(), m.cpu(), 8))
    assert torch.equal(out.long(), (v.long()[:, None] * m.long()).sum(0))
    x = torch.randn(16, 512, generator=gen, device=dev)
    (ca, pa), (cw, pw) = eq.quantize(x * 0.1, 7), eq.quantize(x * 0.02, 7)
    pw = eq.ExpQuantParams(pw.alpha, pw.beta, pa.base, 7)
    cw = eq.encode(x * 0.02, pw)
    t1 = term1_counts(ca, pa, cw, pw)
    cpu = lambda p: eq.ExpQuantParams(p.alpha.cpu(), p.beta.cpu(),
                                      p.base.cpu(), p.bits)
    assert torch.equal(t1.cpu(), term1_counts(ca.cpu(), cpu(pa), cw.cpu(),
                                              cpu(pw)))
    after = _build.launch_counts()
    for name in ("lama_bulk_op", "exp_histogram"):
        assert after.get(name, 0) == before.get(name, 0) + 1


# ------------------------------------------------ one dispatch a tick --

def _replays(call, refresh, check, seeds=(1, 2, 3)):
    """Warm ``call`` up on a side stream, capture it, then for each seed
    write new inputs (``refresh(seed)``), replay and ``check(out)``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # build, load, warm up
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for seed in seeds:
        refresh(seed)
        graph.replay()
        torch.cuda.synchronize()
        check(out)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kind", ["dual", "dual_gated"])
def test_dual_prefill_replays_in_a_cuda_graph(dev, kind, quant):
    """#3 and #4 at a prefill tail chunk's M (tensor-core tiles, split K
    with a workspace and a reduce pass): captured alone and replayed
    after new activation codes are written (the first codes shuffled),
    float out equals the plain version on those codes, and u8 out the
    same kernel called eagerly on them, bit for bit (the plain
    version's float sums may cross an out code's rounding boundary
    where the kernel's do not)."""
    m, k, n = 256, 2048, 2048
    assert gemm_plan(m, k, n, _sms(), 2 if kind == "dual_gated" else 1)[0] > 1
    gen = _gen(dev, 59)
    if kind == "dual":
        x, call, ref = _plain_call(kind, m, k, n, "gather", None, dev, gen,
                                   quant=quant)
    else:
        x, call, ref, _ = _gated_call(kind, m, k, n, "gather", None, dev, gen,
                                      quant=quant)
    first = x.clone()

    def refresh(seed):
        perm = torch.randperm(m * k, generator=_gen(dev, seed), device=dev)
        x.copy_(first.flatten()[perm].view(m, k))

    def check(out):
        if quant:
            assert out.dtype == torch.uint8 and torch.equal(out, call())
        else:
            _close(out, ref())
    _replays(call, refresh, check)


@pytest.mark.parametrize("codes", [False, True])
def test_flash_prefill_replays_in_a_cuda_graph(dev, codes):
    """#5 and #6 take their dynamic shared memory limit once, before any
    capture: captured alone and replayed after new queries, starts and
    lengths are written, they equal the plain versions on those."""
    gen = _gen(dev, 61)
    b, n_kv, g, bs, s = 4, 2, 2, 16, 64
    max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, False)
    if codes:
        kp, vp, bt, kl, vl = _code_pages(dev, gen, b, n_kv, bs, max_blk)
        q, ql, _ = _act_codes((b, s, n_kv, g, 128), dev, gen)
        oq = torch.tensor([0.02, 1e-4, 1.04, 7.0], device=dev)
        args = (q, kp, vp, ql, kl, vl, oq, bt, q_start, kv_lens)
        call = lambda: flash_prefill_paged_codes(*args)
        check = lambda out: _codes_close(
            out, flash_prefill_paged_codes_ref(*args))
    else:
        kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32)
        q = torch.randn(b, s, n_kv, g, 128, generator=gen, device=dev)
        args = (q, kp, vp, bt, q_start, kv_lens)
        call = lambda: flash_prefill_paged(*args)
        check = lambda out: _close(out, flash_prefill_paged_ref(*args))

    def refresh(seed):
        g2 = _gen(dev, seed)
        if codes:
            q.copy_(torch.randint(0, 256, q.shape, generator=g2, device=dev))
        else:
            q.copy_(torch.randn(q.shape, generator=g2, device=dev))
        start = torch.tensor([0, seed, bs * seed + 1, 5], dtype=torch.int32,
                             device=dev)
        valid = torch.tensor([s, s - 9 * seed, s // seed, 0],
                             dtype=torch.int32, device=dev)
        q_start.copy_(start)
        kv_lens.copy_(torch.where(valid > 0, start + valid, 0))
    _replays(call, refresh, check)


def _tiny_card_cfg():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b").replace(
        num_layers=2, d_model=256, num_heads=2, num_kv_heads=1, head_dim=128,
        d_ff=512, vocab_size=1024, compute_dtype="float32")


def _tiny_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, n).astype(np.int32) for n in (5, 40, 70, 17)]


def _counting_api(eng):
    """Wrap the engine's two step entry points so that every Python call
    of them (an eager tick, or a capture) is counted."""
    import dataclasses

    calls = {"prefill": 0, "decode": 0}
    api = eng.api

    def prefill(*a, **kw):
        calls["prefill"] += 1
        return api.prefill_into_cache(*a, **kw)

    def decode(*a, **kw):
        calls["decode"] += 1
        return api.decode_step_paged(*a, **kw)
    eng.api = dataclasses.replace(api, prefill_into_cache=prefill,
                                  decode_step_paged=decode)
    return calls


@pytest.mark.parametrize("codes", [False, True])
def test_engine_replays_its_ticks_as_eager_ticks(dev, codes, tmp_path,
                                                 monkeypatch):
    """With graphs on, each shape key runs its step eagerly once and is
    captured once; every later tick at the key replays (the step
    functions are called twice a key, however many ticks).  The token
    streams and the launch counts equal an eager engine's on the same
    weights (and tables), and a second request set replays only."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    monkeypatch.setenv("REPRO_ACT_CALIB_CACHE", str(tmp_path / "calib.json"))
    cfg = _tiny_card_cfg()
    ec = EngineConfig(num_slots=3, block_size=16, max_seq_len=96,
                      prefill_chunk=32)
    kw = dict(act_quant=7, kv_codes=True) if codes else {}
    on = Engine(cfg, quant_bits=7, engine=ec, device="cuda", rng_seed=3, **kw)
    off = Engine(cfg, params=on.params, engine=ec, device="cuda",
                 kv_codes=codes, cuda_graphs=False)
    assert on.cuda_graphs and not off.cuda_graphs
    calls = _counting_api(on)
    prompts = _tiny_prompts()
    reqs = lambda: [Request(i, p, 10) for i, p in enumerate(prompts)]
    _build.reset_launch_counts()
    a = on.generate(reqs())
    counts_on = _build.launch_counts()
    _build.reset_launch_counts()
    b = off.generate(reqs())
    counts_off = _build.launch_counts()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert counts_on == counts_off
    runners = on.step_runners
    for kind in ("prefill", "decode"):
        assert calls[kind] == 2 * len(runners[kind])
        assert all(r.graph is not None for r in runners[kind].values())
    assert on.total_decode_steps > len(runners["decode"])
    assert sum(r.replays for r in runners["decode"].values()) == (
        on.total_decode_steps - len(runners["decode"]))
    assert on.graph_captures()[0] == sum(map(len, runners.values()))
    assert all(r.graph is None for d in off.step_runners.values()
               for r in d.values())
    before = dict(calls)
    c = on.generate(reqs())
    assert calls == before                 # every key captured: replays only
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x.tokens, y.tokens)


def test_replayed_tick_logits_equal_the_eager_tick(dev):
    """One prefill tick and one decode tick as a step runner returning
    the logits: the replay's logits equal the eager run's bit for bit
    (the same kernels in the same order), and a second replay after the
    inputs are rewritten equals an eager run on those inputs."""
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    from repro_torch.runtime.step_graph import StepGraph

    cfg = _tiny_card_cfg()
    eng = Engine(cfg, quant_bits=7, device="cuda", rng_seed=3,
                 engine=EngineConfig(num_slots=3, block_size=16,
                                     max_seq_len=96, prefill_chunk=32))
    eng.generate([Request(0, _tiny_prompts()[2], 4)])
    rng = np.random.default_rng(8)
    b, cols = 3, 4
    table = rng.permutation(np.arange(1, eng.cache.k_pages.shape[1]))[:b * cols]

    def prefill(v):
        return eng.api.prefill_into_cache(
            eng.params, v["tokens"], eng.cache.bind(v["table"], v["lengths"]),
            cfg, v["start"])[0]

    def decode(v):
        return eng.api.decode_step_paged(
            eng.params, eng.cache.bind(v["table"], v["lengths"]),
            v["tokens"], v["mask"] != 0, cfg)[0]

    cases = [(prefill, {"table": (b, cols), "lengths": (b,), "start": (b,),
                        "tokens": (b, 32)},
              lambda: {"lengths": rng.integers(1, 64, b),
                       "start": rng.integers(0, 24, b)}),
             (decode, {"table": (b, cols), "lengths": (b,), "tokens": (b, 1),
                       "mask": (b,)},
              lambda: {"lengths": rng.integers(0, 63, b),
                       "mask": rng.integers(0, 2, b)})]
    for fn, inputs, draw in cases:
        eager = StepGraph(inputs, dev, graphs=False)
        run = StepGraph(inputs, dev, graphs=True)
        for i in range(3):
            vals = {"table": table.reshape(b, cols),
                    "tokens": rng.integers(0, 1024, inputs["tokens"]), **draw()}
            for r in (eager, run):
                for k, a in vals.items():
                    r.host[k][...] = a
            want = eager.step(fn).clone()
            got = run.step(fn).clone()
            assert torch.equal(got, want), (fn.__name__, i)
            run.capture(fn)
        assert run.replays == 2


def test_engine_capture_failure_raises(dev):
    """A step that fails while it is captured raises out of the tick:
    the engine neither falls back to the eager step nor replays."""
    import dataclasses

    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    eng = Engine(_tiny_card_cfg(), quant_bits=7, device="cuda", rng_seed=3,
                 engine=EngineConfig(num_slots=2, block_size=16,
                                     max_seq_len=96, prefill_chunk=32))
    api = eng.api

    def decode(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused under capture")
        return api.decode_step_paged(*a, **kw)
    eng.api = dataclasses.replace(api, decode_step_paged=decode)
    with pytest.raises(RuntimeError, match="refused under capture"):
        eng.generate([Request(0, _tiny_prompts()[0], 6)])
    (run,) = eng.step_runners["decode"].values()
    assert run.graph is None and run.replays == 0
    torch.cuda.synchronize()


def test_bucketed_decode_replays_one_graph_a_bucket(dev):
    """generate_bucketed with graphs on and off on the same weights:
    equal token streams and launch counts, ``decode_gqa`` launched once
    a layer and decode step, one graph captured per bucket."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.server import InferenceServer, Request

    cfg = _tiny_card_cfg()
    on = InferenceServer(cfg, quant_bits=7, max_len=96, num_slots=3,
                         device="cuda", rng_seed=3)
    off = InferenceServer(cfg, params=on.params, max_len=96, num_slots=3,
                          device="cuda", cuda_graphs=False)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, 1024, n).astype(np.int32), 12)
            for i, n in enumerate((9, 9, 33, 33, 50))]
    outs, counts = [], []
    for srv in (on, off):
        _build.reset_launch_counts()
        outs.append(srv.generate_bucketed(reqs))
        counts.append(_build.launch_counts())
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert counts[0] == counts[1]
    assert counts[0]["decode_gqa"] == cfg.num_layers * 3 * 11
    assert on.bucket_graphs == 3 and off.bucket_graphs == 0


# ----------------------------------------------------- f8 KV, layouts --

F8 = torch.float8_e4m3fn


def _f8_pages(dev, gen, b, n_kv, bs, max_blk, hd=128):
    """float8_e4m3fn pages from N(0, 4) values (the e4m3 grid's coarse
    steps, a few subnormals and values near 448 among them)."""
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32, hd)
    return (kp * 4).to(F8), (vp * 4).to(F8), bt


@pytest.mark.parametrize("g,hd,bs,s,long", [
    (2, 128, 16, 37, False), (5, 128, 16, 256, False), (1, 64, 48, 20, False),
    (8, 128, 8, 16, False), (2, 128, 16, 256, True), (10, 256, 128, 37, False),
])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_flash_prefill_f8_pages(dev, g, hd, bs, s, long, qdt):
    gen = _gen(dev, 300 + g + hd + bs)
    b, n_kv = 4, 2
    max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, long)
    kp, vp, bt = _f8_pages(dev, gen, b, n_kv, bs, max_blk, hd)
    q = torch.randn(b, s, n_kv, g, hd, generator=gen, device=dev).to(qdt)
    out = flash_prefill_paged(q, kp, vp, bt, q_start, kv_lens)
    _close(out, flash_prefill_paged_ref(q, kp, vp, bt, q_start, kv_lens))
    assert torch.all(out[3] == 0)


@pytest.mark.parametrize("g,hd,bs,long", [
    (1, 128, 16, False), (2, 128, 16, True), (5, 128, 64, False),
    (8, 64, 16, False), (10, 256, 128, False), (16, 128, 16, True),
])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_decode_gqa_paged_f8_pages(dev, g, hd, bs, long, qdt):
    gen = _gen(dev, 400 + g + hd + bs + long)
    b, n_kv = 5, 2
    max_blk, lengths = _decode_rows(dev, bs, long)
    kp, vp, bt = _f8_pages(dev, gen, b, n_kv, bs, max_blk, hd)
    q = torch.randn(b, n_kv, g, hd, generator=gen, device=dev).to(qdt)
    out = decode_gqa_paged(q, kp, vp, bt, lengths)
    _close(out, decode_gqa_paged_ref(q, kp, vp, bt, lengths))
    assert torch.all(out[1] == 0)


@pytest.mark.parametrize("g,hd", [(2, 128), (1, 64), (5, 128), (10, 256)])
def test_decode_gqa_contiguous_f8_cache(dev, g, hd):
    from repro_torch.kernels.decode_gqa import decode_gqa
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_ref

    gen = _gen(dev, 500 + g + hd)
    b, s, n_kv = 6, 200, 2
    q = torch.randn(b, n_kv, g, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn(b, s, n_kv, hd, generator=gen, device=dev) * 4).to(F8)
    v = (torch.randn(b, s, n_kv, hd, generator=gen, device=dev) * 4).to(F8)
    lengths = torch.tensor([1, 0, 64, s + 60, -3, 131], dtype=torch.int32,
                           device=dev)
    out = decode_gqa(q, k, v, lengths)
    _close(out, decode_gqa_ref(q, k, v, lengths.clamp(0, s)))
    assert torch.all(out[1] == 0) and torch.all(out[4] == 0)


def test_f8_pages_replay_in_a_cuda_graph(dev):
    """#5, #7 and #9 on float8_e4m3fn pages and caches, captured together
    and replayed after new queries and lengths are written, equal their
    plain versions on those."""
    from repro_torch.kernels.decode_gqa import decode_gqa
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_ref

    gen = _gen(dev, 62)
    b, n_kv, g, bs, s = 4, 2, 2, 16, 64
    max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, False)
    kp, vp, bt = _f8_pages(dev, gen, b, n_kv, bs, max_blk)
    qp = torch.randn(b, s, n_kv, g, 128, generator=gen, device=dev)
    qd = torch.randn(b, n_kv, g, 128, generator=gen, device=dev)
    lengths = torch.tensor([5, 0, 40, 100], dtype=torch.int32, device=dev)
    kc = (torch.randn(b, 200, n_kv, 128, generator=gen, device=dev) * 4).to(F8)
    vc = (torch.randn(b, 200, n_kv, 128, generator=gen, device=dev) * 4).to(F8)

    def call():
        return (flash_prefill_paged(qp, kp, vp, bt, q_start, kv_lens),
                decode_gqa_paged(qd, kp, vp, bt, lengths),
                decode_gqa(qd, kc, vc, lengths))

    def refresh(seed):
        g2 = _gen(dev, seed)
        qp.copy_(torch.randn(qp.shape, generator=g2, device=dev))
        qd.copy_(torch.randn(qd.shape, generator=g2, device=dev))
        lengths.copy_(torch.tensor([seed * 30, 3, 0, 128 - seed],
                                   dtype=torch.int32))
        valid = torch.tensor([s, s - 9 * seed, s // seed, 0],
                             dtype=torch.int32, device=dev)
        kv_lens.copy_(torch.where(valid > 0, q_start + valid, 0))

    def check(out):
        _close(out[0], flash_prefill_paged_ref(qp, kp, vp, bt, q_start, kv_lens))
        _close(out[1], decode_gqa_paged_ref(qd, kp, vp, bt, lengths))
        _close(out[2], decode_gqa_ref(qd, kc, vc, lengths))
    _replays(call, refresh, check)


@pytest.mark.parametrize("g,hd,bs", [(10, 256, 16), (16, 128, 16),
                                     (8, 256, 128), (2, 128, 128)])
@pytest.mark.parametrize("kernel", ["prefill", "prefill_codes", "decode",
                                    "decode_codes", "contiguous"])
def test_attention_kernels_at_head_dim_256_g_16_and_block_128(dev, kernel, g,
                                                              hd, bs):
    """#5-#9 at the layouts past PR 18's: head_dim 256 (paligemma's g 8,
    recurrentgemma's g 10), g 16 (two row groups in the decode kernels)
    and blocks of 128 positions."""
    from repro_torch.kernels.decode_gqa import decode_gqa
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_ref

    gen = _gen(dev, 950 + g * 10 + hd + bs)
    b, n_kv = 4, 2
    oq = torch.tensor([0.02, 1e-4, 1.04, 7.0], device=dev)
    if kernel.startswith("prefill"):
        s = 37
        max_blk, q_start, kv_lens = _prefill_rows(dev, bs, s, False)
        shape = (b, s, n_kv, g, hd)
    else:
        b = 5
        max_blk, lengths = _decode_rows(dev, bs, False)
        shape = (b, n_kv, g, hd)
    if kernel.endswith("codes"):
        kc, vc, bt, kl, vl = _code_pages(dev, gen, b, n_kv, bs, max_blk, hd)
        qc, ql, _ = _act_codes(shape, dev, gen)
        args = (qc, kc, vc, ql, kl, vl, oq, bt)
        if kernel == "prefill_codes":
            args += (q_start, kv_lens)
            _codes_close(flash_prefill_paged_codes(*args),
                         flash_prefill_paged_codes_ref(*args))
        else:
            args += (lengths,)
            _codes_close(decode_gqa_paged_codes(*args),
                         decode_gqa_paged_codes_ref(*args))
        return
    q = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    if kernel == "contiguous":
        k = torch.randn(b, 200, n_kv, hd, generator=gen, device=dev)
        v = torch.randn(b, 200, n_kv, hd, generator=gen, device=dev)
        out = decode_gqa(q, k, v, lengths)
        _close(out, decode_gqa_ref(q, k, v, lengths.clamp(0, 200)))
        return
    kp, vp, bt = _pages(dev, gen, b, n_kv, bs, max_blk, torch.float32, hd)
    if kernel == "prefill":
        args = (q, kp, vp, bt, q_start, kv_lens)
        out = flash_prefill_paged(*args)
        _close(out, flash_prefill_paged_ref(*args))
        assert torch.all(out[3] == 0)
    else:
        out = decode_gqa_paged(q, kp, vp, bt, lengths)
        _close(out, decode_gqa_paged_ref(q, kp, vp, bt, lengths))
        assert torch.all(out[1] == 0)


def test_f8_write_cast_on_the_card_equals_the_cpu(dev):
    """``cache_cast`` to float8_e4m3fn gives the CPU's bytes on the card,
    float32 and bfloat16 in: the rounding inside the range and NaN of
    the input's sign past 464, at +-inf and at NaN (the CPU's bytes are
    held to the reference's in tests/test_torch_f8_kv.py)."""
    from repro_torch.models.transformer import cache_cast

    r = np.random.default_rng(5)
    x = np.concatenate([
        r.normal(size=20000) * 64, r.normal(size=2000) * 1e-3,
        np.array([448, 463.9, 464, 464.01, 480, 1e6, np.inf, 0.0, np.nan,
                  2.0 ** -10, 3 * 2.0 ** -11]),
        -np.array([448, 463.9, 464, 464.01, 480, 1e6, np.inf, 0.0, np.nan])
    ]).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(x).to(dt)
        want = cache_cast(t, F8).view(torch.uint8)
        got = cache_cast(t.to(dev), F8).view(torch.uint8).cpu()
        assert torch.equal(got, want)


def test_minicpm_odd_vocab_tied_unembedding(dev):
    """minicpm-2b's tied unembedding at its vocabulary, 122753 (odd): the
    transposed-codes kernel at decode (M = 8) and prefill (M = 256) rows
    masks the tail columns."""
    gen = _gen(dev, 81)
    n, k = 122753, 2304
    codes, lut, qmeta = _qweight((n, k), dev, gen)
    for m in (8, 256):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        out = lut_dequant_matmul(x, codes, lut, transpose_codes=True,
                                 out_dtype=torch.float32)
        assert out.shape == (m, n)
        _close(out, lut_dequant_matmul_ref(x, codes, lut,
                                           transpose_codes=True))
