"""``launch/trace_analysis.py``, the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``, on the CPU.

The reference's analyzer tests mirrored: a loop of L products, nested
loops, and remat's recompute (3 to 5 times the forward's products, the
reference's bounds), each also held against ``hlo_analysis.analyze`` of
the same program under ``lax.scan``; a collective inside a loop counted L
times. Then what is the port's own: a kernel entry's replayed count equals
its plain version's counted in place (all seven kernels), the memory
tracker's figures on known allocations, and the dry run's step on fake
ranks: at (2, 2, 2) and (16, 16) a dense step's all-reduce bytes are the
rank's float32 gradients (and the clipping norm's scalar over 'model'),
an MoE prefill's all-to-all bytes are ``moe_apply_ep``'s buffers, and two
gloo ranks (``tests/test_torch_dist.py``'s harness) count the same ops and
bytes as two fake ranks. Every count is exact: FLOPs, dots and bytes are
integers. And ``chunked_attend``'s high-water over three query chunks:
one chunk's float32 logits live at a time.
"""
import contextlib
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze
from repro_torch import distributed as D
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch import trace_analysis as TA
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_dist_ranks as ranks  # noqa: E402


def _compile(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


@contextlib.contextmanager
def fake(n: int):
    """This process as rank 0 of a fake world of ``n``, torn down after."""
    DR.fake_world(n)
    try:
        yield
    finally:
        D.shutdown_world()


# ------------------------------------------ the reference's tests mirrored

def test_loop_flops_match_scan():
    L, B, Dm = 8, 64, 128
    w = torch.zeros((L, Dm, Dm))
    x = torch.zeros((B, Dm))

    def unrolled(x, w):
        for l in range(L):
            x = torch.tanh(x @ w[l])
        return x

    _, fig = TA.trace(unrolled, x, w)
    expect = 2.0 * L * B * Dm * Dm
    assert fig["flops_dot"] == expect and fig["dot_count"] == L

    def scanned(x, w):
        return jax.lax.scan(lambda c, wl: (jnp.tanh(c @ wl), None), x, w)[0]
    ana = analyze(_compile(scanned, jnp.zeros((B, Dm)),
                           jnp.zeros((L, Dm, Dm))))
    assert ana["flops_dot"] == pytest.approx(fig["flops_dot"], rel=0.01)


def test_nested_loops():
    L1, L2, B, Dm = 4, 3, 32, 64
    w = torch.zeros((L1, L2, Dm, Dm))

    def f(x, w):
        for i in range(L1):
            for j in range(L2):
                x = x @ w[i, j]
        return x

    _, fig = TA.trace(f, torch.zeros((B, Dm)), w)
    assert fig["flops_dot"] == 2.0 * L1 * L2 * B * Dm * Dm

    def g(x, w):
        inner = lambda c, wl: (c @ wl, None)
        return jax.lax.scan(lambda c, ws: (jax.lax.scan(inner, c, ws)[0],
                                           None), x, w)[0]
    ana = analyze(_compile(g, jnp.zeros((B, Dm)),
                           jnp.zeros((L1, L2, Dm, Dm))))
    assert ana["flops_dot"] == pytest.approx(fig["flops_dot"], rel=0.01)


def test_remat_recompute_counted():
    """Checkpointed layers (``remat_blocks``'s ``checkpoint``): forward,
    recompute and two backward products a layer, the first layer's input
    gradient not needed: 4L - 1 products, within the reference's 3-5x of
    the forward."""
    L, B, Dm = 4, 32, 64
    w = torch.zeros((L, Dm, Dm), requires_grad=True)
    x = torch.zeros((B, Dm))

    def layer(c, wl):
        return torch.tanh(c @ wl)

    def step(x, w):
        out = x
        for l in range(L):
            out = torch.utils.checkpoint.checkpoint(
                layer, out, w[l], use_reentrant=False,
                preserve_rng_state=False)
        torch.sum(out * out).backward()

    _, fig = TA.trace(step, x, w)
    base = 2.0 * L * B * Dm * Dm
    assert 3.0 * base <= fig["flops_dot"] <= 5.0 * base
    assert fig["dot_count"] == 4 * L - 1

    def loss(x, w):
        out, _ = jax.lax.scan(jax.checkpoint(
            lambda c, wl: (jnp.tanh(c @ wl), None)), x, w)
        return jnp.sum(out * out)
    ana = analyze(_compile(jax.grad(loss, argnums=1), jnp.zeros((B, Dm)),
                           jnp.zeros((L, Dm, Dm))))
    assert 3.0 * base <= ana["flops_dot"] <= 5.0 * base


def test_collectives_scale_with_trip_count():
    """An all-reduce inside a loop of L, on a fake world of 4: L calls of
    the (B, D) float32 operand, one call site."""
    L, B, Dm = 6, 32, 64
    with fake(4):
        mesh = DR.make_mesh((4,), ("model",))
        group = mesh.group("model")

        def f(x):
            for _ in range(L):
                torch.distributed.all_reduce(x, group=group)
            return x

        _, fig = TA.trace(f, torch.empty((B, Dm), device="meta"))
    assert fig["collective_bytes"]["all-reduce"] == L * B * Dm * 4
    assert fig["collective_counts_dynamic"]["all-reduce"] == L
    assert fig["collective_counts_static"]["all-reduce"] == 1
    assert fig["collective_bytes_total"] == L * B * Dm * 4


# ------------------------------------------------ the kernels' reported work

def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g)
    q, kp, vp = rn(3, 8, 16), rn(6, 4, 2, 16), rn(6, 4, 2, 16)
    bt = torch.tensor([[1, 2], [3, 0], [4, 5]])
    lens = torch.tensor([7, 3, 8])
    return {
        "gar_matmul": (ops._gar_plain, (rn(5, 12), rn(12, 4), rn(6, 4),
                                        torch.randperm(10, generator=g)), {}),
        "gar_tail": (ref.gar_tail_ref, (rn(5, 4), rn(6, 4)), {}),
        "lowrank_matmul": (ref.lowrank_matmul_ref,
                           (rn(5, 12), rn(12, 6), rn(9, 6), 4), {}),
        "paged_attention": (ref.paged_attention_ref,
                            (q, kp, vp, bt, lens), {"window": 4}),
        "paged_prefill_attention": (
            ref.paged_prefill_attention_ref,
            (q, kp, vp, bt, torch.tensor([0, 2, 1]), lens), {}),
        "topk_mask_sample": (ref.topk_mask_sample_ref,
                             (rn(3, 50), torch.ones(3), None,
                              torch.rand(3, generator=g)),
                             {"return_probs": True}),
        "wkv6": (ops._wkv_plain, (rn(2, 10, 2, 4), rn(2, 10, 2, 4),
                                  rn(2, 10, 2, 4),
                                  torch.rand(2, 10, 2, 4, generator=g),
                                  rn(2, 4), 4), {}),
        "ssd": (ops._ssd_plain, (rn(2, 10, 2, 4), torch.rand(
            2, 10, 2, generator=g), -torch.rand(2, generator=g),
            rn(2, 10, 1, 3), rn(2, 10, 1, 3), 4), {}),
    }


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_kernel_replay_counts_the_plain_version(name):
    """``count_kernel`` (what an entry reports where the kernel launches:
    its plain version replayed on ``meta``) equals ``plain_kernel`` (the
    plain version counted as it runs) on the same arguments."""
    plain, args, kw = _kernel_cases()[name]
    with TA.StepTrace(memory=False) as ran:
        with TA.plain_kernel(name):
            plain(*args, **kw)
    with TA.StepTrace(memory=False) as replayed:
        TA.count_kernel(name, plain, *args, **kw)
    a, b = ran.result(), replayed.result()
    assert a["flops_dot"] == b["flops_dot"] and a["dot_count"] == \
        b["dot_count"]
    assert a["kernel_work"] == b["kernel_work"]
    assert a["kernel_work"][name]["calls"] == 1
    if name != "topk_mask_sample":
        assert a["flops_dot"] > 0


def test_kernel_entries_report_under_a_trace():
    """The entries themselves (CPU tensors: the plain versions in place)
    record their work under the kernel's name, once a call."""
    x, v, u = torch.randn(6, 8), torch.randn(8, 4), torch.randn(5, 4)
    with TA.StepTrace(memory=False) as tr:
        ops.lowrank_forward(x, v, u, 3)
        ops.lowrank_forward(x, v, u, 3)
    w = tr.result()["kernel_work"]["lowrank_matmul"]
    assert w == {"calls": 2, "flops": 2.0 * 2 * (6 * 8 * 4 + 6 * 4 * 5),
                 "dots": 4}


# ------------------------------------------------------------ memory

def test_memory_high_water_and_arguments():
    arg = torch.empty(1000)                     # 4000 B, live throughout

    def step(a):
        t1 = torch.empty(2000)                  # 8000 B
        t2 = t1 + 1                             # 8000 B: 16000 live
        del t1
        t3 = t2[:10]                            # a view: no bytes
        out = torch.empty(500)                  # 2000 B
        del t2, t3
        a.add_(1)                               # in place: no bytes
        return out

    _, fig = TA.trace(step, arg)
    assert fig["bytes"] == {"argument": 4000, "output": 2000,
                            "temp": 16000, "peak": 20000}


def _attend_temp(chunks: int) -> tuple:
    """The temp high-water of ``chunked_attend`` over ``chunks`` query
    chunks against 3 * ``Q_CHUNK`` keys on ``meta``, with one chunk's
    float32 logits and output bytes."""
    from repro_torch.models import attention as attn
    b, hq, hkv, d, t = 2, 4, 2, 16, 3 * attn.Q_CHUNK
    s = chunks * attn.Q_CHUNK
    q = torch.empty(b, s, hq, d, device="meta")
    k, v = (torch.empty(b, t, hkv, d, device="meta") for _ in range(2))
    _, fig = TA.trace(attn.chunked_attend, q, k, v,
                      q_positions=torch.arange(s, device="meta"),
                      k_positions=torch.arange(t, device="meta"), window=t)
    return (fig["bytes"]["temp"], b * hq * attn.Q_CHUNK * t * 4,
            b * attn.Q_CHUNK * hq * d * 4)


def test_chunked_attend_holds_one_chunk_of_logits():
    """Three query chunks of ``chunked_attend`` hold no more than one
    chunk does, but for the other two chunks' outputs (kept in the list,
    then stacked): one chunk's float32 logits are live at a time. Were
    the last chunk's logits and probabilities kept while the next
    chunk's are built, the three would take two chunks' logits more."""
    one, logits, out = _attend_temp(1)
    three, _, _ = _attend_temp(3)
    assert three - one <= 4 * out < logits


# ------------------------------------------------------------ fake ranks

def _grad_numel(args) -> int:
    return sum(t.numel() for t in cm.tree_leaves(args[0]))


@pytest.mark.parametrize("shape", [(2, 2, 2), (16, 16)],
                         ids=["2x2x2", "16x16"])
def test_dense_step_all_reduce_is_the_gradients(shape):
    """A dense train step: beside the forward and backward's own
    tensor-parallel collectives over 'model' (their loss and gradient
    traced alone), one all-reduce of the rank's gradients as one float32
    buffer over the data axes and one float32 scalar (the clipping norm's
    split part) over 'model'; no other collective."""
    cfg = get_config("deepseek-7b", smoke=True)
    with fake(math.prod(shape)):
        mesh = DR.make_mesh(shape, ("pod", "data", "model")[-len(shape):])
        n_data = mesh.size(D.data_axes(mesh))
        step, args, _ = DR.build_step(
            cfg, ShapeConfig("t", 32, 2 * n_data, "train"), mesh, "dense")
        params, _, batch, rng = args

        def backward():
            with tfm.remat_blocks():
                step.loss_fn(params, batch, rng).backward()
        with D.mesh_context(mesh):
            _, tp = TA.trace(backward)
            SP.clear_grads(params)
            _, fig = TA.trace(step, *args)
    assert tp["collective_bytes"]["all-reduce"] > 0
    assert fig["collective_bytes"]["all-reduce"] == \
        tp["collective_bytes"]["all-reduce"] + 4 * _grad_numel(args) + 4
    assert fig["collective_counts_dynamic"]["all-reduce"] == \
        tp["collective_counts_dynamic"]["all-reduce"] + 2
    for kind in ("all-gather", "all-to-all", "reduce-scatter"):
        assert fig["collective_bytes"][kind] == tp["collective_bytes"][kind]
    assert fig["collective_bytes"]["all-to-all"] == 0


def test_moe_prefill_all_to_all_is_the_dispatch_buffers():
    """An MoE prefill at (2, 2, 2): each MoE layer sends its (E, C, d)
    dispatch buffer and takes it back, C the capacity of the rank's
    slice of B x S / n_model tokens, in bfloat16."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    m = cfg.moe
    b_loc, s = 2, 64
    with fake(8):
        mesh = DR.make_mesh((2, 2, 2), ("pod", "data", "model"))
        step, args, _ = DR.build_step(
            cfg, ShapeConfig("p", s, 4 * b_loc, "prefill"), mesh, "dense")
        with D.mesh_context(mesh):
            _, fig = TA.trace(step, *args)
    tc = b_loc * s // mesh.shape["model"]
    cap = max(math.ceil(tc * m.top_k * m.capacity_factor / m.num_experts),
              4)
    layers = sum(sg.count for sg in cfg.segments if sg.kind == "attn")
    buf = m.num_experts * cap * cfg.d_model * 2
    assert fig["collective_bytes"]["all-to-all"] == 2 * layers * buf
    assert fig["collective_counts_dynamic"]["all-to-all"] == 2 * layers


def test_gloo_ranks_count_as_fake_ranks(tmp_path):
    """Two gloo ranks and two fake ranks (this process standing for rank
    0) run deepseek-moe-16b's smoke train step at (1, 2), all-to-alls
    included: the same FLOPs, products and collective bytes and calls on
    every rank."""
    import test_torch_dist as harness
    np.savez(tmp_path / "inputs.npz")
    job = {"kind": "count", "arch": "deepseek-moe-16b", "mode": "dense",
           "step": "train", "seq": 16, "batch": 2}
    real = harness.run_pool(tmp_path, (1, 2), [job], deadline=240)
    cfg = get_config(job["arch"], smoke=True)
    with fake(2):
        mesh = D.elastic_remesh((1, 2), ("data", "model"))
        step, args, _ = DR.build_step(
            cfg, ShapeConfig("t", job["seq"], job["batch"], job["step"]),
            mesh, job["mode"], dtype=torch.float32)
        with D.mesh_context(mesh):
            _, fig = TA.trace(step, *args)
    want = {k: float(v) for k, v in ranks.trace_counts(fig).items()}
    assert want["calls/all-to-all"] > 0
    for r, got in enumerate(real):
        assert {k: float(v) for k, v in got.items()} == want, r
