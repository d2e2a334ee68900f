"""Which flash-attention kernel takes which inputs, and how launches are
counted per kernel.

``_variant`` is a pure function of dtype, head dims (q/k's and v's), base
pointers and strides, so it runs here on CPU tensors.  The launch path is driven with the
compiled libraries replaced by fakes (there is no card or nvcc here), which
shows the wrapper counts each launch once, under the kernel it chose, and
raises on a launch error without trying the other kernel.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

bf16, f32 = torch.bfloat16, torch.float32


def _bhsd(B, H, KH, S, D, dtype=bf16):
    return (torch.zeros(B, H, S, D, dtype=dtype),
            torch.zeros(B, KH, S, D, dtype=dtype),
            torch.zeros(B, KH, S, D, dtype=dtype))


def _bshd_views(B, H, KH, S, D, dtype=bf16):
    """(B, S, H, D) tensors viewed as (B, H, S, D), as the model passes them."""
    return tuple(torch.zeros(B, S, h, D, dtype=dtype).transpose(1, 2)
                 for h in (H, KH, KH))


def _mla(B, H, S, D, Dv, dtype=bf16):
    """(B, S, H, D) q/k and (B, S, H, Dv) v viewed as (B, H, S, .), as MLA
    passes them (one K per head)."""
    return (torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2),
            torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2),
            torch.zeros(B, S, H, Dv, dtype=dtype).transpose(1, 2))


def _padded_rows(B, H, KH, S, D, pad, dtype=bf16):
    """Rows of D + pad elements with the last ``pad`` cut off: S-stride D + pad."""
    return tuple(torch.zeros(B, h, S, D + pad, dtype=dtype)[..., :D]
                 for h in (H, KH, KH))


@pytest.mark.parametrize("make,want", [
    (lambda: _bhsd(1, 2, 1, 128, 64), "wgmma"),
    (lambda: _bhsd(2, 4, 2, 256, 128), "wgmma"),
    (lambda: _bhsd(1, 8, 2, 96, 80), "wgmma"),
    (lambda: _bshd_views(4, 32, 4, 512, 64), "wgmma"),
    (lambda: _bshd_views(1, 8, 1, 300, 80), "wgmma"),
    (lambda: _bhsd(1, 2, 1, 128, 64, f32), "scalar"),
    (lambda: _bshd_views(2, 32, 4, 64, 64, f32), "scalar"),
    (lambda: _bhsd(1, 2, 1, 64, 12), "scalar"),
    (lambda: _padded_rows(1, 2, 1, 64, 64, 4), "scalar"),
    (lambda: _padded_rows(1, 2, 1, 64, 64, 8), "wgmma"),
    (lambda: _mla(4, 128, 512, 192, 128), "wgmma"),
    (lambda: _mla(1, 4, 64, 24, 16), "wgmma"),
    (lambda: _mla(1, 4, 64, 136, 128), "wgmma"),
    (lambda: _mla(4, 128, 512, 192, 128, f32), "scalar"),
    (lambda: _mla(1, 4, 64, 200, 128), "wgmma"),
    (lambda: _mla(1, 4, 64, 192, 136), "wgmma"),
    (lambda: _mla(1, 4, 64, 192, 12), "scalar"),
    (lambda: _bhsd(1, 16, 1, 512, 256), "wgmma"),
    (lambda: _bshd_views(4, 16, 1, 512, 256), "wgmma"),
    (lambda: _mla(1, 4, 64, 256, 128), "wgmma"),
    (lambda: _mla(1, 4, 64, 192, 256), "wgmma"),
], ids=["bf16-d64", "bf16-d128", "bf16-d80", "bf16-bshd-view",
        "bf16-bshd-view-ragged-d80", "f32", "f32-bshd-view", "bf16-d12",
        "bf16-s-stride-68", "bf16-s-stride-72", "bf16-mla-192-128",
        "bf16-mla-smoke-24-16", "bf16-qk136-v128", "f32-mla-192-128",
        "bf16-qk200", "bf16-v136", "bf16-v12", "bf16-d256", "bf16-bshd-view-d256",
        "bf16-qk256-v128", "bf16-qk192-v256"])
def test_variant_from_dtype_shape_and_strides(make, want):
    q, k, v = make()
    assert flash_kernel._variant(q, k, v) == want


def test_variant_needs_16_byte_aligned_pointers():
    flat = torch.zeros(2 * 64 * 64 + 4, dtype=bf16)
    q = flat[4:].view(1, 2, 64, 64)          # 8 bytes past an aligned base
    k = v = flat[:64 * 64].view(1, 1, 64, 64)
    assert q.data_ptr() % 16 == 8
    assert flash_kernel._variant(q, k, v) == "scalar"
    assert flash_kernel._variant(k, k, v) == "wgmma"


def _fake_launches(monkeypatch, fail=()):
    """Replace the compiled kernels with fakes that record which one ran (and
    return an error code for the variants in ``fail``); pretend every tensor
    lies on the card."""
    ran = []

    def fake(variant):
        def fn(*args):
            ran.append(variant)
            return 700 if variant in fail else 0
        return fn, lambda err: b"an illegal memory access was encountered"

    monkeypatch.setattr(flash_kernel, "_fn", fake)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return ran


def test_head_dim_256_launches_the_cuda_core_kernel(monkeypatch):
    """Head dim 256 launches the CUDA-core kernel in f32 only: bf16 aligned
    inputs at q/k 256 (v 256 or 128) launch the tensor-core kernel's
    (256, 256) bucket, as MLA's (192, 128) launches its own."""
    ran = _fake_launches(monkeypatch)
    ops.reset_launch_counts()
    flash_kernel.flash_attention(*_bshd_views(4, 16, 1, 64, 256))
    flash_kernel.flash_attention(*_mla(1, 4, 64, 256, 128))
    flash_kernel.flash_attention(*_bshd_views(4, 16, 1, 64, 256, f32))
    flash_kernel.flash_attention(*_mla(1, 4, 64, 192, 128))
    assert ran == ["wgmma", "wgmma", "scalar", "wgmma"]
    assert flash_kernel.launches_by_variant == {"wgmma": 3, "scalar": 1}
    ops.reset_launch_counts()


def test_launches_by_variant_sum_to_launches_and_reset(monkeypatch):
    ran = _fake_launches(monkeypatch)
    ops.reset_launch_counts()
    flash_kernel.flash_attention(*_bshd_views(2, 4, 2, 16, 64))
    flash_kernel.flash_attention(*_bhsd(1, 2, 1, 16, 64, f32), causal=False)
    flash_kernel.flash_attention(*_bhsd(1, 2, 1, 16, 12))
    flash_kernel.flash_attention_scalar(*_bhsd(1, 2, 1, 16, 64))
    assert ran == ["wgmma", "scalar", "scalar", "scalar"]
    assert flash_kernel.launches_by_variant == {"wgmma": 1, "scalar": 3}
    assert sum(flash_kernel.launches_by_variant.values()) == flash_kernel.launches == 4
    assert ops.launch_counts() == {"flash_attention": 4, "rmsnorm": 0,
                                   "fused_adam": 0, "dgc_mask": 0}
    ops.reset_launch_counts()
    assert flash_kernel.launches_by_variant == {"wgmma": 0, "scalar": 0}
    assert flash_kernel.launches == 0


def test_launch_error_raises_without_falling_back(monkeypatch):
    ran = _fake_launches(monkeypatch, fail=("wgmma",))
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match=r"\(wgmma\).*illegal memory access"):
        flash_kernel.flash_attention(*_bhsd(1, 2, 1, 16, 64))
    assert ran == ["wgmma"]
    assert flash_kernel.launches == 0
    assert flash_kernel.launches_by_variant == {"wgmma": 0, "scalar": 0}


def test_output_keeps_the_bshd_layout(monkeypatch):
    _fake_launches(monkeypatch)
    q, k, v = _bshd_views(2, 4, 2, 16, 64)
    o = flash_kernel.flash_attention(q, k, v)
    assert o.shape == q.shape and o.stride() == q.stride()
    ops.reset_launch_counts()


def test_mla_output_has_the_v_head_dim_in_the_bshd_layout(monkeypatch):
    """With q/k head dim 192 and v head dim 128 the output is
    (B, H, S, 128) in q's memory layout: a transposed view of a contiguous
    (B, S, H, 128) tensor; a (B, H, S, D) q gives a contiguous one."""
    ran = _fake_launches(monkeypatch)
    ops.reset_launch_counts()
    o = flash_kernel.flash_attention(*_mla(2, 4, 16, 192, 128))
    assert o.shape == (2, 4, 16, 128) and o.transpose(1, 2).is_contiguous()
    q = torch.zeros(2, 4, 16, 24, dtype=bf16)
    o = flash_kernel.flash_attention(q, q[:, :2], torch.zeros(2, 2, 16, 16, dtype=bf16))
    assert o.shape == (2, 4, 16, 16) and o.is_contiguous()
    assert ran == ["wgmma", "wgmma"]
    assert flash_kernel.launches_by_variant == {"wgmma": 2, "scalar": 0}
    ops.reset_launch_counts()


def test_wgmma_buckets_fit_in_shared_memory():
    """Each head-dim bucket of the tensor-core kernel, its shared memory
    recomputed from the constants of ``flash_attention_wgmma.cu``: Q's tile
    of ``kBlockM`` rows, K/V tiles of ``block_n(Dv)`` keys, atoms of
    ``kAtomCols`` columns, ``kMaxStages`` stages where they fit and 2
    otherwise, the barriers and the alignment; each fits in ``kSmemLimit``,
    the H100's 232,448 bytes a block.  The (64, 64), (128, 128) and
    (192, 128) buckets keep their 128-key tiles and stages, and (256, 256)
    takes 64-key tiles in 2 stages."""
    src = (Path(flash_kernel.__file__).resolve().parent.parent / "csrc"
           / "flash_attention_wgmma.cu").read_text()
    c = {k: int(re.search(rf"constexpr (?:int|uint32_t) {k} = (\d+);", src)[1])
         for k in ("kBlockM", "kMaxStages", "kSmemLimit", "kAtomCols")}
    rule = re.search(r"int block_n\(int dv\) \{ return dv > (\d+) \? (\d+) : (\d+); \}", src)
    row_bytes = int(re.search(r"atom_bytes\(int rows\) \{ return rows \* (\d+)u; \}", src)[1])

    def block_n(dv):
        return int(rule[2]) if dv > int(rule[1]) else int(rule[3])

    def smem(dqk, dv, stages):
        atoms_q, atoms_v = dqk // c["kAtomCols"], dv // c["kAtomCols"]
        return (atoms_q * c["kBlockM"] * row_bytes
                + stages * (atoms_q + atoms_v) * block_n(dv) * row_bytes
                + 8 * (2 + 4 * stages) + 1024)

    buckets = sorted({(int(a), int(b)) for a, b in re.findall(r"launch<(\d+), (\d+)>", src)})
    got = {}
    for dqk, dv in buckets:
        stages = c["kMaxStages"] if smem(dqk, dv, c["kMaxStages"]) <= c["kSmemLimit"] else 2
        got[(dqk, dv)] = (block_n(dv), stages, smem(dqk, dv, stages))
        assert smem(dqk, dv, stages) <= c["kSmemLimit"] == 232_448
    assert got == {(64, 64): (128, 3, 115_824), (128, 128): (128, 3, 230_512),
                   (192, 128): (128, 2, 214_096), (256, 256): (64, 2, 197_712)}
