"""Port B5, the band engine's im2col (``rslo_tpu_torch.ops.band_conv.
band_gather``), against the JAX package, on the submanifold rulebook of a
real tiny frame (the plans of ``tests/test_torch_band_conv.py``):

  * the plain contract bit-equal to JAX's ``_windowed_pallas_gather``
    (interpret mode), and the fused d_W mode (``overflow=``) bit-equal,
    as int32 bit patterns, to JAX's chain ``_windowed_pallas_gather`` ->
    ``_overflow_add_g`` -> ``astype(float32)``, at a roomy window, at a
    tiny one where many pairs overflow and at a saturated overflow
    capacity (dropped pairs), in bf16 and f32;
  * NaN feature rows that only sel = -1 would reach stay out; a -0.0
    feature comes out +0.0 at an overflow slot (it is added onto a +0)
    and -0.0 in the window;
  * the wrapper rejects a bad ``overflow`` tuple;
  * the band conv's backward builds d_W's operand in one fused call.

The plain versions are what runs here (CPU tensors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_band_conv import (CDT, TINY_BLOCK, TINY_WINDOW,  # noqa: F401
                                  _inputs, _plans, frame)
from torch_port_helpers import interpreted_pallas, tt

from rslo_tpu.ops import band_conv as jbc
from rslo_tpu_torch.ops import band_conv as bc

CASES = ["roomy", "tiny", "saturated"]
_JAX_RUNS = {}


def _operands(geo, case, cin=16, seed=3):
    """(jax plan, port plan, f_pad (v_in, cin) f32 numpy)."""
    jplan, plan, (lin, lout, rb, _, _) = _plans(geo, "subm", case)
    f = _inputs(geo, lin, lout, rb, seed, cin=cin)[0]
    f_pad = np.zeros((plan.v_in, cin), np.float32)
    f_pad[:len(f)] = f
    return jplan, plan, f_pad


def _overflow(plan):
    return plan.ov_out, plan.ov_in, plan.ov_tap


def _jax(frame, case, precision, monkeypatch):
    """JAX's im2col and its d_W chain, once per (case, precision): the
    port's plan, f_pad, and both results as numpy arrays."""
    key = (case, precision)
    if key not in _JAX_RUNS:
        interpreted_pallas(monkeypatch)
        jplan, plan, f_pad = _operands(frame, case)
        nB, K, B = plan.sel.shape
        jcdt = CDT[precision][1]

        def chain(f_, base, sel, ov_out, ov_in, ov_tap):
            g = jbc._windowed_pallas_gather(f_, base, sel, jplan.window, jcdt)
            dw = jbc._overflow_add_g(g, f_, ov_out, ov_in, ov_tap, nB * B, K,
                                     f_.shape[1])
            return g, dw.astype(jnp.float32)
        # jitted: an eager interpret-mode pallas_call is traced anew each call
        g, dw = jax.jit(chain)(jnp.asarray(f_pad), jplan.base, jplan.sel,
                               jplan.ov_out, jplan.ov_in, jplan.ov_tap)
        _JAX_RUNS[key] = plan, f_pad, np.asarray(g), np.asarray(dw)
    return _JAX_RUNS[key]


def _bits(x):
    """Bit patterns of a torch tensor or a numpy array (bf16: int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).numpy()
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x.view(np.int32)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_gather_bit_equal_to_jax(frame, case, precision, monkeypatch):
    plan, f_pad, g_jax, _ = _jax(frame, case, precision, monkeypatch)
    g = bc.band_gather(tt(f_pad), plan.base, plan.sel, CDT[precision][0])
    assert g.dtype == CDT[precision][0] and g.shape == g_jax.shape
    np.testing.assert_array_equal(_bits(g), _bits(g_jax))


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_fused_dw_operand_bit_equal_to_jax(frame, case, precision,
                                           monkeypatch):
    plan, f_pad, _, dw_jax = _jax(frame, case, precision, monkeypatch)
    Vp = plan.sel.shape[0] * plan.sel.shape[2]
    stored = int((plan.ov_out < Vp).sum())
    assert stored == min(int(plan.ov_count), plan.ov_capacity)
    if case == "tiny":
        assert stored > 100          # the overflow pass has work
    if case == "saturated":
        assert int(plan.ov_count) > plan.ov_capacity == stored > 0
    dw = bc.band_gather(tt(f_pad), plan.base, plan.sel, CDT[precision][0],
                        overflow=_overflow(plan))
    assert dw.dtype == torch.float32 and dw.shape == dw_jax.shape
    np.testing.assert_array_equal(_bits(dw), _bits(dw_jax))


def _reached(plan, n_rows):
    """(n_rows,) bool: rows that an in-window pair or a stored overflow
    pair reads."""
    Vp = plan.sel.shape[0] * plan.sel.shape[2]
    used = torch.zeros(n_rows, dtype=torch.bool)
    used[(plan.base[:, :, None] + plan.sel)[plan.sel >= 0].long()] = True
    used[plan.ov_in[plan.ov_out < Vp].long()] = True
    return used


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_nan_rows_behind_invalid_sel_stay_out(frame, precision):
    """Every 5th input row (and row 0, which dropped overflow slots
    name) is made unreachable, its taps invalid, and NaN."""
    _, _, (lin, lout, rb, _, _) = _plans(frame, "subm", "tiny")
    f = tt(_inputs(frame, lin, lout, rb, 5)[0])
    hidden = torch.zeros(len(f), dtype=torch.bool)
    hidden[::5] = True
    cut = type(rb)(rb.idx, rb.valid & ~hidden[rb.idx.long()])
    plan = bc.build_band_index(cut, len(f), block=TINY_BLOCK,
                               window=TINY_WINDOW,
                               ov_capacity=int(cut.valid.sum()) + 64,
                               self_transpose=True)
    f = bc.pad_rows(f, plan.v_in)
    used = _reached(plan, len(f))
    assert int(plan.ov_count) > 100 and not used[hidden].any()
    f_nan = torch.where(used[:, None], f, float("nan"))
    cdt = CDT[precision][0]
    for ov in (None, _overflow(plan)):
        got = bc.band_gather(f_nan, plan.base, plan.sel, cdt, overflow=ov)
        want = bc.band_gather(f, plan.base, plan.sel, cdt, overflow=ov)
        assert torch.isfinite(got.float()).all()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_negative_zero_at_overflow_slots_comes_out_positive(frame,
                                                            precision):
    """The chain adds the rounded overflow row onto B5's +0.0, so -0.0
    comes out +0.0 there; in the window B5 copies -0.0 as it is."""
    _, plan, f_pad = _operands(frame, "tiny")
    nB, K, B = plan.sel.shape
    Vp, Cin = nB * B, f_pad.shape[1]
    f = tt(f_pad)
    f[::3] = -0.0
    cdt = CDT[precision][0]
    dw = bc.band_gather(f, plan.base, plan.sel, cdt,
                        overflow=_overflow(plan))
    want = bc.overflow_add_g(bc.band_gather_plain(f, plan.base, plan.sel,
                                                  cdt), f,
                             *_overflow(plan)).float()
    np.testing.assert_array_equal(_bits(dw), _bits(want))
    bits = _bits(dw).reshape(Vp, K, Cin)
    keep = plan.ov_out < Vp
    ov_rows = plan.ov_in[keep].long()
    ov_bits = bits[plan.ov_out[keep].long(), plan.ov_tap[keep].long()]
    neg = (ov_rows % 3 == 0).numpy()
    assert neg.sum() > 10
    assert (ov_bits[neg] == 0).all()              # +0.0
    sel = plan.sel.permute(0, 2, 1).reshape(Vp, K)
    src = (plan.base[:, None, :].expand(nB, B, K).reshape(Vp, K) + sel)
    in_win = (sel >= 0) & (src % 3 == 0)
    assert in_win.sum() > 10
    assert (bits[in_win.numpy()] == np.int32(-2 ** 31)).all()   # -0.0


def _bad_overflows(plan):
    ov = _overflow(plan)
    return {
        "two tensors": ov[:2],
        "int64 ov_in": (ov[0], ov[1].long(), ov[2]),
        "2-D ov_tap": (ov[0], ov[1], ov[2][:, None]),
        "short ov_out": (ov[0][:-1], ov[1], ov[2]),
        "ov_out on another device": (ov[0].to("meta"), ov[1], ov[2]),
        "strided ov_in": (ov[0], torch.stack([ov[1], ov[1]], 1)[:, 0],
                          ov[2]),
    }


@pytest.mark.parametrize("bad", [
    "two tensors", "int64 ov_in", "2-D ov_tap", "short ov_out",
    "ov_out on another device", "strided ov_in"])
def test_band_gather_rejects_a_bad_overflow(frame, bad):
    _, plan, f_pad = _operands(frame, "roomy")
    with pytest.raises(ValueError, match="overflow|ov_"):
        bc.band_gather(tt(f_pad), plan.base, plan.sel, torch.bfloat16,
                       overflow=_bad_overflows(plan)[bad])


def test_backward_builds_dw_operand_in_one_fused_call(frame, monkeypatch):
    """One ``band_gather`` call a submanifold plan, in the fused mode,
    and the same d_W as the three-pass chain times ct."""
    _, plan, (lin, lout, rb, rb_t, _) = _plans(frame, "subm", "tiny")
    f, w, b, ct, om = _inputs(frame, lin, lout, rb, 4)
    calls = []
    gather = bc.band_gather

    def recording(*args, **kwargs):
        out = gather(*args, **kwargs)
        calls.append((kwargs.get("overflow"), out.dtype))
        return out
    monkeypatch.setattr(bc, "band_gather", recording)
    tw = tt(w).requires_grad_()
    bc.band_conv(tt(f), plan, tw, tt(b), om, torch.bfloat16, rb,
                 rb_t).backward(tt(ct))
    assert len(calls) == 1
    assert calls[0][0] is not None and calls[0][1] == torch.float32
    f_pad = bc.pad_rows(tt(f), plan.v_in)
    g = bc.overflow_add_g(bc.band_gather_plain(
        f_pad, plan.base, plan.sel, torch.bfloat16), f_pad,
        *_overflow(plan)).float()
    ctm = torch.where(om[:, None], tt(ct), 0.0)
    want = (g.t() @ bc.pad_rows(ctm, g.shape[0])).reshape(w.shape)
    np.testing.assert_array_equal(_bits(tw.grad), _bits(want))
