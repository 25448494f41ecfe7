"""The flash forward entries' host side on the CPU: the operands and strides
they hand the kernel (computed from shapes, not from views) equal those of
the strided [B, H, S, D] views the kernel reads, and shapes the kernel has
no instantiation for are refused before any launch. The kernel itself runs
only on the card (chip_smoke.py phase 3)."""

import pytest
import torch

from ctrlora_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def captured(monkeypatch):
    """Record what the entries would launch, with the device check off."""
    calls = []

    def launch(what, ptrs, shape, strides, scale, device):
        calls.append({"what": what, "ptrs": list(ptrs), "shape": tuple(shape),
                      "strides": list(strides), "scale": scale})
        return torch.empty(shape[:3])

    monkeypatch.setattr(fa, "_launch_forward", launch)
    monkeypatch.setattr(fa, "_check_operands", lambda what, ts: None)
    return calls


def _bhsd_args(q, k, v, out):
    views = [t.transpose(1, 2) for t in (q, k, v, out)]
    return ([t.data_ptr() for t in views],
            [t.stride(i) for t in views for i in (0, 2, 1)])


@pytest.mark.parametrize("s, h, d", [(4096, 8, 40), (1024, 8, 80), (256, 8, 160)])
def test_qkv_entry_hands_the_kernel_the_views_strides(captured, s, h, d):
    qkv = torch.zeros((2, s, 3 * h * d), dtype=torch.bfloat16)
    out, _ = fa._forward_qkv(qkv, h, d, 0.1)
    q, k, v = fa._split_qkv(qkv, h, d)
    ptrs, strides = _bhsd_args(q, k, v, out.view(2, s, h, d))
    call = captured[0]
    assert call["ptrs"] == ptrs and call["strides"] == strides
    assert call["shape"] == (2, h, s, s, d) and out.shape == (2, s, h * d)


def test_bshd_entry_hands_the_kernel_the_views_strides(captured):
    base = torch.zeros((2, 512, 3, 8, 40), dtype=torch.bfloat16)
    q, k, v = base.unbind(2)  # strided [B, S, H, D] views
    out, _ = fa._forward_bshd(q, k, v, 0.1, "flash_attention_bshd")
    ptrs, strides = _bhsd_args(q, k, v, out.view(2, 512, 8, 40))
    assert captured[0]["ptrs"] == ptrs and captured[0]["strides"] == strides


@pytest.mark.parametrize("d, sq, sk", [(96, 256, 256), (40, 200, 256), (40, 256, 192),
                                       (512, 4096, 4080), (256, 256, 256)])
def test_shapes_without_a_kernel_are_refused(d, sq, sk):
    with pytest.raises(ValueError, match="forward kernel takes"):
        fa._launch_forward("flash_attention", [0] * 4, (1, 1, sq, sk, d), [8 * 64] * 12, 1.0,
                           "cpu")


@pytest.mark.parametrize("d", fa.FORWARD_HEAD_DIMS)
def test_every_instantiated_head_dim_has_tiles(d):
    bq, bk = fa.forward_tiles(d)
    assert 4096 % bq == 0 and 4096 % bk == 0
