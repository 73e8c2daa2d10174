"""The port's count of work (``roofline/cost.py``): the JAX package's unit
cases of ``tests/test_roofline.py`` for the port (a plain matmul exact, a
batched product, INT8 flagged, a declared loop counted n times, bytes
growing with the trip count), the kernels counted at their op boundary
whatever branch runs, and the same count on CPU tensors and on meta
tensors, exactly, for deeper stacks of the four families, whose layer
groups, recurrences, rows and experts the meta device runs collapsed (the
smoke cells' CPU == meta is held with the reference, in
``test_torch_cost_ref*.py``)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_cost_common import B, deep, port_count  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.roofline import H100_SXM, cost, roofline_terms  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count(fn, *args):
    with cost.record() as c:
        fn(*args)
    return c


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_matmul_flops_exact(device):
    a = torch.zeros((64, 128), device=device)
    b = torch.zeros((128, 32), device=device)
    c = _count(lambda: a @ b)
    assert c.flops == 2 * 64 * 128 * 32 and c.int8_dot_flops == 0
    assert c.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert c.ops == {"mm": 1} and c.collective_bytes == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_batched_dot_flops(device):
    a = torch.zeros((4, 16, 32), device=device)
    b = torch.zeros((4, 32, 8), device=device)
    c = _count(lambda: torch.einsum("bij,bjk->bik", a, b))
    assert c.flops == 2 * 4 * 16 * 32 * 8
    # a product of contraction 1 is a multiply (XLA rewrites it so)
    assert _count(lambda: a[..., :1] @ b[:, :1]).flops == 0


def test_int8_dot_flagged():
    a = torch.ones((32, 64), dtype=torch.int8)
    b = torch.ones((64, 16), dtype=torch.int8)
    c = _count(torch._int_mm, a, b)
    assert c.int8_dot_flops == c.flops == 2 * 32 * 64 * 16
    # B1 at its op boundary: 2·M·K·N INT8, whatever the plain version does
    w_s = torch.ones(16)
    x = torch.ones((32, 64), dtype=torch.bfloat16)
    c = _count(ops.int8_matmul, x, b, w_s)
    assert c.int8_dot_flops == c.flops == 2 * 32 * 64 * 16
    assert c.ops == {"int8_matmul_quant": 1}
    assert c.bytes == 32 * 64 * 2 + 64 * 16 + 16 * 4 + 32 * 16 * 2


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_declared_loop_counted_n_times(device):
    x = torch.zeros((16, 64), device=device)
    w = torch.zeros((64, 64), device=device)

    def scanned(n):
        h, outs = x, []
        for _ in cost.loop(n, x):
            h = torch.tanh(h @ w)
            outs.append(h)
        return cost.catted(outs, n, stack=True)
    for n in (1, 3, 8):
        c = _count(scanned, n)
        assert c.flops == n * 2 * 16 * 64 * 64
        assert c.ops["mm"] == c.ops["tanh"] == n
    assert scanned(8).shape == (8, 16, 64)
    b4, b16 = _count(scanned, 4).bytes, _count(scanned, 16).bytes
    assert 3.0 < b16 / b4 < 5.0


def test_loop_collapses_only_on_meta():
    ran = []
    for device in ("cpu", "meta"):
        x = torch.zeros(1, device=device)
        with cost.record():
            ran.append(list(cost.loop(10, x)))
    assert ran == [list(range(10)), [0, 1, 9]]
    assert list(cost.loop(10, torch.zeros(1, device="meta"))) == list(
        range(10))      # no recorder: every step


def test_attention_ops_count_their_window():
    b, hq, hkv, hd, w = 2, 4, 2, 16, 24
    q = torch.zeros((b, hq, hd), dtype=torch.bfloat16)
    cache = {"k": torch.zeros((b, 64, hkv, hd), dtype=torch.bfloat16),
             "v": torch.zeros((b, 64, hkv, hd), dtype=torch.bfloat16)}
    c = _count(ops.decode_attention, q[:, None], cache, 3, w)
    assert c.flops == 4 * b * hq * w * hd
    assert c.ops["decode_attention"] == 1   # beside the start vector's fill
    c = _count(ops.prefill_attention, q[:, None].expand(b, 5, hq, hd),
               cache, 3, w)
    assert c.flops == 4 * b * 5 * hq * w * hd


def test_differentiable_flash_counts_backward():
    cfg = configs.get_smoke_config("qwen3-0.6b")
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    p = lm.init_params(cfg, device="cpu")["blocks"][0]["attn"]
    p = {k: {"w": v["w"].requires_grad_()} for k, v in p.items()}
    x = torch.randn((B, 8, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(8)[None].expand(B, 8)
    with torch.enable_grad():
        want = A.attention_forward(p, cfg, x, pos, route=A.TRAIN)
        g_want = torch.autograd.grad(want.float().sum(),
                                     [v["w"] for v in p.values()])
        with cost.record() as c:
            got = A.attention_forward(p, cfg, x, pos, route=A.TRAIN)
            g_got = torch.autograd.grad(got.float().sum(),
                                        [v["w"] for v in p.values()])
    # the same bits with the recorder as without
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    hd = cfg.resolved_head_dim
    fwd = 4 * B * 8 * 8 * cfg.n_heads * hd
    assert c.ops["flash_attention"] == c.ops["flash_attention_backward"] == 1
    proj = 2 * B * 8 * cfg.d_model * (2 * cfg.n_heads + 2 * cfg.n_kv_heads
                                      ) * hd
    # each weight's gradient, and the input gradient of wo only: x takes
    # none
    assert c.flops == 3 * fwd + 2 * proj + 2 * B * 8 * cfg.n_heads * hd * (
        cfg.d_model)
    terms = roofline_terms(c, H100_SXM)
    assert terms["t_compute"] == c.flops / H100_SXM.peak_bf16
    assert terms["t_memory"] == c.bytes / H100_SXM.hbm_bw
    assert terms["t_collective"] == 0
    assert terms["step_time_lower_bound_s"] == max(terms["t_compute"],
                                                   terms["t_memory"])


def test_recorders_do_not_nest():
    with cost.record():
        with pytest.raises(RuntimeError, match="already active"):
            with cost.record():
                pass


@pytest.mark.parametrize("variant,kind", [("baseline", "train"),
                                          ("baseline", "prefill"),
                                          ("hqp", "decode")])
@pytest.mark.parametrize("arch,n_layers", [("qwen3-0.6b", 5),
                                           ("phi3.5-moe-42b-a6.6b", 4),
                                           ("jamba-1.5-large-398b", 8),
                                           ("xlstm-1.3b", 8)])
def test_deep_cpu_count_equals_meta_count(arch, n_layers, variant, kind):
    """Four layer groups or more: the meta device runs the first, one that
    counts for the middle ones, and the last, and the same for the
    recurrences' steps, the per-row products, the experts and (at a
    128-position train step) the mLSTM's chunks."""
    cfg = deep(arch, n_layers)
    s = 128 if kind == "train" else 32
    got = port_count(cfg, variant, kind, "cpu", train_s=s)
    assert got.counts() == port_count(cfg, variant, kind, "meta",
                                      train_s=s).counts()
