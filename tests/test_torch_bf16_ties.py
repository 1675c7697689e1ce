"""bfloat16 caches against the reference: parity up to rounding ties.

Both packages round the same float32 K/V (or MLA latent) values to
bfloat16 as they write them into the cache, but those float32 values agree
only to within the noise of summation order. Where one sits on a bfloat16
rounding midpoint, the two sides may round it to adjacent values, and
every later token that attends to it parts by a little: the port computes
the same thing as the reference, and the run still differs. So a
bfloat16-cache comparison holds what is true (``check_bf16_parity``):

1. in each batch row, every position before the first cache element that
   differs agrees at the caller's float32 tolerance;
2. each element where the difference starts (at that row and position, in
   the first layer that differs there, so its inputs agree on both sides)
   differs by exactly one bfloat16 ulp, and the port's float32 value
   before the rounding lies within ``TIE_SLACK`` of the midpoint of the
   two, relative to the largest magnitude in that token's vector of the
   leaf: a tie, not an error;
3. the rest agrees within ``TOL_BF16_TIE`` relative to the reference's max.

``TOL_BF16_TIE`` is 2u, u = 2^-8 being bfloat16's unit roundoff: after a
tie the two caches are two bfloat16 roundings of one float32 state, each
within u of it, so within 2u of each other, and the bound carries that
relative gap to the outputs. It comes from the format, not from a run.
``TIE_SLACK`` is 2^-19, 16 float32 ulps: the rounding noise of a
projection scales with its terms, not with its result, so it is measured
against the token's vector. A bfloat16 ulp is 2^-7 to 2^-8 of an element,
and a value that rounds one ulp off for any other reason lies anywhere up
to half an ulp (a quarter on average) from the midpoint; only for an
element far smaller than its vector does the noise reach its ulp, and
then its rounding is the noise's to decide.

``Bf16Writes`` finds the port's values before the rounding: a torch
function mode that sees every float32 tensor cast to bfloat16 and, when
the cast is written into a tracked cache leaf, copies the float32 value
into a float32 shadow of that leaf.

The tests here hold the check itself on synthetic caches: a tie passes, a
one-ulp error off the midpoint fails, and so do a two-ulp step, outputs
that part before the first differing element and a rest past the bound.
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

U_BF16 = 2.0 ** -8
TOL_BF16_TIE = 2 * U_BF16
TIE_SLACK = 2.0 ** -19


class Bf16Writes(TorchFunctionMode):
    """Within the context, every float32 tensor cast to bfloat16 and then
    written (``target[index] = value``) into the storage of one of
    ``leaves`` leaves its float32 value at the same place in a shadow;
    ``shadow(leaf)`` gives the shadow of a leaf (NaN where nothing was
    written)."""

    def __init__(self, *leaves):
        super().__init__()
        self._flat = {}
        for t in leaves:
            st = t.untyped_storage()
            self._flat.setdefault(st.data_ptr(), torch.full(
                (st.nbytes() // t.element_size(),), float("nan")))
        self._casts = {}

    def shadow(self, leaf: torch.Tensor) -> torch.Tensor:
        flat = self._flat[leaf.untyped_storage().data_ptr()]
        return flat.as_strided(leaf.size(), leaf.stride(),
                               leaf.storage_offset())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.Tensor.to and isinstance(out, torch.Tensor)
                and out.dtype == torch.bfloat16
                and args[0].dtype == torch.float32):
            self._casts[id(out)] = (out, args[0])
        elif func is torch.Tensor.__setitem__:
            target, index, value = args
            cast = self._casts.pop(id(value), None)
            if (cast is not None and target.untyped_storage().data_ptr()
                    in self._flat):
                self.shadow(target)[index] = cast[1]
        return out


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """The bfloat16 bit pattern of float32 values that are bfloat16."""
    return (a.view(np.uint32) >> 16).astype(np.int64)


def check_bf16_parity(out_t, out_j, caches_t, caches_j, shadows, *,
                      tol: float) -> dict:
    """Hold a bfloat16-cache run of the port against the reference's.

    ``out_t``, ``out_j``: (B, S, ...) outputs at positions 0..S-1 (the
    logits of a prefill and the steps after it, concatenated); ``caches_t``,
    ``caches_j``, ``shadows``: one list entry per layer in the order the
    model runs them, each a dict of leaves (B, T, ...) with batch rows on
    axis 0 and positions on axis 1 (``shadows``: the port's float32 values
    before the rounding, from ``Bf16Writes``). ``tol``: the float32
    comparison's relative bound. Returns, per row, the first differing
    position (S where none) and the tie elements found."""
    out_t, out_j = _f32(out_t), _f32(out_j)
    b, s = out_j.shape[:2]
    scale = float(np.abs(out_j).max()) + 1e-12
    diffs = []          # (layer, leaf, index) of every differing element
    for layer, (lt, lj) in enumerate(zip(caches_t, caches_j)):
        assert lt.keys() == lj.keys()
        for name in lt:
            a, c = _f32(lt[name]), _f32(lj[name])
            assert a.shape == c.shape, name
            diffs += [(layer, name, tuple(i)) for i in np.argwhere(a != c)]
    first = [s] * b
    for _, _, idx in diffs:
        first[idx[0]] = min(first[idx[0]], int(idx[1]))
    ties = []
    for r in range(b):
        p = first[r]
        gap = float(np.abs(out_t[r, :p] - out_j[r, :p]).max(initial=0.0))
        assert gap / scale < tol, (r, p, gap / scale)
        if p == s:
            continue
        starts = [d for d in diffs if d[2][0] == r and d[2][1] == p]
        layer = min(d[0] for d in starts)
        for _, name, idx in (d for d in starts if d[0] == layer):
            a = _f32(caches_t[layer][name])[idx]
            c = _f32(caches_j[layer][name])[idx]
            shadow = _f32(shadows[layer][name])
            pre = float(shadow[idx])
            scale_v = float(np.abs(shadow[idx[:2]]).max())
            mid = (float(a) + float(c)) / 2
            steps = abs(int(_bf16_bits(np.array([a]))[0])
                        - int(_bf16_bits(np.array([c]))[0]))
            assert np.sign(a) == np.sign(c) and steps == 1, \
                (layer, name, idx, float(a), float(c))
            assert abs(pre - mid) <= TIE_SLACK * scale_v, \
                (layer, name, idx, pre, mid, scale_v)
            ties.append((layer, name, idx))
        rest = float(np.abs(out_t[r, p:] - out_j[r, p:]).max())
        assert rest / scale < TOL_BF16_TIE, (r, p, rest / scale)
    return {"first": first, "ties": ties}


# ------------------------------------------------------- the check itself

def _synthetic(kind):
    """One layer of a (B 2, T 4, 3) cache and its outputs, with a
    difference of ``kind`` at row 1, position 2."""
    rng = np.random.default_rng(0)
    pre = rng.standard_normal((2, 4, 3)).astype(np.float32)
    lo = torch.tensor(1.5).to(torch.bfloat16)
    ulp = 2.0 ** -7                   # bfloat16 spacing on [1, 2)
    pre[1, 2, 1] = float(lo) + ulp / 2 if kind != "off_midpoint" \
        else float(lo) + ulp / 4
    cache_t = torch.tensor(pre).to(torch.bfloat16)
    cache_j = cache_t.clone()
    cache_t[1, 2, 1] = float(lo) + ulp
    cache_j[1, 2, 1] = float(lo) if kind != "two_ulps" else float(lo) - ulp
    out_j = rng.standard_normal((2, 4, 5)).astype(np.float32)
    out_t = out_j.copy()
    out_t[1, 2:] += {"tie": 1e-3, "off_midpoint": 1e-3, "two_ulps": 1e-3,
                     "early": 1e-3, "far": 0.1}[kind]
    if kind == "early":
        out_t[1, 1] += 1e-3
    return out_t, out_j, [{"k": cache_t}], [{"k": cache_j}], \
        [{"k": torch.tensor(pre)}]


def test_a_rounding_tie_passes():
    got = check_bf16_parity(*_synthetic("tie"), tol=1e-4)
    assert got == {"first": [4, 2], "ties": [(0, "k", (1, 2, 1))]}


@pytest.mark.parametrize("kind", ["off_midpoint", "two_ulps", "early", "far"])
def test_anything_but_a_tie_fails(kind):
    with pytest.raises(AssertionError):
        check_bf16_parity(*_synthetic(kind), tol=1e-4)


def test_writes_record_the_value_before_rounding():
    """The shadow holds what was cast, at the place it was written, through
    a view of a layer (as the models index their caches)."""
    leaf = torch.zeros(2, 3, 4, dtype=torch.bfloat16)
    x = torch.randn(3, 2)
    with Bf16Writes(leaf) as rec:
        view = leaf[1]
        view[:, 1:3] = x.to(view.dtype)
        leaf[0, 0, 0] = 7.0           # not a cast: nothing is recorded
    sh = rec.shadow(leaf)
    torch.testing.assert_close(sh[1, :, 1:3], x, rtol=0, atol=0)
    assert torch.isnan(sh[0]).all() and torch.isnan(sh[1, :, 0]).all()
