"""The host side of the port's redesigned kernels, on the CPU: the launch
plans that ``kernels/int8_matmul.py`` (B1, from an int8 x or from a bf16 x
that the launch quantizes), ``kernels/flash_attention.py`` (B7),
``kernels/prefill_attention.py`` (B4, B6) and
``kernels/decode_attention.py`` (B3, B5) hand to their CUDA kernels, and the
build key. The kernels themselves run only on the card (``chip_smoke.py``);
these tests hold the plans to what the kernels assume: every output tile,
every K row, every (query, head) row and every KV position covered exactly
once, enough blocks to fill the H100's 132 SMs at decode shapes, shared
memory within a Hopper block's 232,448 bytes, copy and load widths that
divide the row pitch, split-KV segments at absolute positions, and
workspaces that the model's shapes never outgrow, made once per device;
and a library rebuilt when a header it includes changes."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import int8_matmul as km  # noqa: E402
from repro_torch.kernels import prefill_attention as kp  # noqa: E402

D_MODEL, D_FF, KV = 1024, 3072, 512       # qwen3-0.6b at the repo's hd 64
DECODE_KN = [(D_MODEL, KV), (D_MODEL, D_MODEL), (D_MODEL, D_FF),
             (D_FF, D_MODEL)]
# a per-layer cut: d_ff 3,035 and 7 kv heads (448 columns)
RAGGED_KN = [(3035, D_MODEL), (D_MODEL, 3035), (D_MODEL, 448)]
M_ROWS = [1, 4, 13, 16, 17, 64]
SMEM_MAX = 232_448          # dynamic shared memory a block may use on Hopper
PAGE_SIZES = (16, 32, 48, 256)      # the paged kernels' checks on the card
DECODE_W = [16, 64, 100, 256, 4096, 40960]


def _covers(plan, m, n, k):
    assert (plan.m_tiles - 1) * km.BM < m <= plan.m_tiles * km.BM
    assert (plan.n_tiles - 1) * km.BN < n <= plan.n_tiles * km.BN
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(lo < hi for lo, hi in ranges)
    assert plan.grid == (plan.n_tiles, plan.m_tiles, plan.split)


@pytest.mark.parametrize("k,n", DECODE_KN + RAGGED_KN)
@pytest.mark.parametrize("m", M_ROWS)
def test_gemm_plan_covers_the_product(m, k, n):
    plan = km.gemm_plan(m, n, k)
    _covers(plan, m, n, k)
    assert plan.smem <= SMEM_MAX
    assert n % plan.vec == 0 and k % plan.x_vec == 0
    # the split-K workspace: the (M, N) sums and one counter per tile
    want = m * n + plan.m_tiles * plan.n_tiles if plan.split > 1 else 0
    assert plan.workspace == want <= km.WORKSPACE_MIN


@pytest.mark.parametrize("k,n", DECODE_KN + RAGGED_KN)
@pytest.mark.parametrize("m", [4, 16])
def test_gemm_plan_fills_the_card_at_decode_and_prefill(m, k, n):
    """Decode (M = 4 slots) and a prefill chunk (M = 16) launch at least
    one block per SM, N = 512 included, with whole 32-row K steps."""
    plan = km.gemm_plan(m, n, k)
    assert plan.blocks >= km.N_SMS
    assert plan.m_tiles == 1


@pytest.mark.parametrize("n,ptr,want", [(1024, 0, 16), (448, 0, 16),
                                        (1000, 0, 8), (1012, 0, 4),
                                        (3035, 0, 1), (1024, 8, 8),
                                        (1024, 4, 4), (1024, 3, 1)])
def test_gemm_copy_width_follows_alignment(n, ptr, want):
    plan = km.gemm_plan(4, n, 1024, w_ptr=ptr)
    assert plan.vec == want
    assert n % plan.vec == 0 and ptr % plan.vec == 0


@pytest.mark.parametrize("k,n", DECODE_KN + RAGGED_KN)
@pytest.mark.parametrize("m", M_ROWS)
def test_gemm_plan_bf16_x_covers_the_product(m, k, n):
    """The fused form (x bf16, quantized in the launch) takes the int8
    form's grid and K ranges; its shared memory adds one f32 scale a tile
    row, and fits; it loads x 16 bytes (8 values) at a time where K % 8 ==
    0, else one value."""
    plan = km.gemm_plan(m, n, k, x_bytes=2)
    _covers(plan, m, n, k)
    int8_x = km.gemm_plan(m, n, k)
    assert (plan.grid, plan.ksteps, plan.vec, plan.workspace) == (
        int8_x.grid, int8_x.ksteps, int8_x.vec, int8_x.workspace)
    assert plan.smem == int8_x.smem + km.BM * 4 <= SMEM_MAX
    assert plan.smem == (km.RING_BYTES
                         + km.BM * (plan.ksteps * km.KSTEP + 16) + km.BM * 4)
    assert plan.x_vec == (16 if k % 8 == 0 else 2)


@pytest.mark.parametrize("k,ptr,x_bytes,want", [
    (1024, 0, 2, 16), (3072, 32, 2, 16), (1024, 8, 2, 2), (1024, 2, 2, 2),
    (1020, 0, 2, 2), (3035, 0, 2, 2), (1024, 0, 1, 4), (1024, 2, 1, 1),
    (3035, 0, 1, 1)])
def test_gemm_x_width_follows_k_and_the_pointer(k, ptr, x_bytes, want):
    """x's load width: a row of K values of ``x_bytes`` each starts on the
    width only if K is a multiple of the values a load takes and x's
    pointer is aligned; a ragged K (3,035) or pointer loads by element."""
    plan = km.gemm_plan(4, 1024, k, x_ptr=ptr, x_bytes=x_bytes)
    assert plan.x_vec == want
    assert (k * x_bytes) % want == 0 and ptr % want == 0


def test_gemm_plan_x_width_and_long_k():
    assert km.gemm_plan(4, 1024, 3035).x_vec == 1
    assert km.gemm_plan(4, 1024, 1024, x_ptr=2).x_vec == 1
    assert km.gemm_plan(4, 1024, 1024).x_vec == 4
    # a K too long for one block's x tile is split however many tiles N has
    m, n, k = 64, 8192, 65536
    for x_bytes in (1, 2):
        plan = km.gemm_plan(m, n, k, x_bytes=x_bytes)
        _covers(plan, m, n, k)
        assert plan.split > 1 and plan.smem <= SMEM_MAX
    # K = 0 still launches one range, which writes zeros
    assert km.gemm_plan(4, 64, 0).k_ranges(0) == [(0, 0)]


@pytest.mark.parametrize("b,s,hq,hkv", [(2, 32, 16, 8), (1, 2048, 16, 8),
                                        (1, 1000, 16, 8), (2, 256, 8, 8),
                                        (2, 67, 6, 2), (1, 5, 24, 1),
                                        (2, 608, 32, 32)])
def test_flash_plan_covers_every_row(b, s, hq, hkv):
    plan = kf.flash_plan(b, s, hq, hkv)
    g = hq // hkv
    assert plan.queries * g <= kf.ROWS
    assert plan.queries * g > kf.ROWS - g          # at most G - 1 idle rows
    heads, tiles, batch = plan.grid
    assert (heads, batch) == (hkv, b)
    assert (tiles - 1) * plan.queries < s <= tiles * plan.queries


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("sq", [1, 5, 16, 53, 256])
def test_prefill_plan_covers_every_row(sq, g):
    """Every (query, head) row of a chunk falls in exactly one block, row
    r of tile y being query y * bq + r // G of head r % G, with bq =
    floor(16 * warps / G) as in the kernel; no tile starts past Sq."""
    b, hkv = 2, 3
    plan = kp.prefill_plan(b, sq, hkv, g)
    assert 1 <= plan.warps <= kp.MAX_WARPS
    heads, tiles, batch = plan.grid
    assert (heads, batch) == (hkv, b)
    rows = kp.ROWS_PER_WARP * plan.warps
    bq = rows // g
    assert bq >= 1
    seen = {}
    for y in range(tiles):
        assert y * bq < sq                      # no tile starts past Sq
        for r in range(bq * g):
            qi, head = y * bq + r // g, r % g
            if qi < sq:
                seen[qi, head] = seen.get((qi, head), 0) + 1
    assert seen == {(qi, head): 1 for qi in range(sq) for head in range(g)}


def test_prefill_plan_sizes_the_block_to_the_chunk():
    """The serve chunk (16 queries, G = 2) is one 2-warp block a kv head; a
    whole 256-token prompt takes 64-row blocks; one query of G = 32 heads
    needs two warps."""
    assert kp.prefill_plan(1, 16, 8, 2) == kp.PrefillPlan(2, (8, 1, 1))
    assert kp.prefill_plan(1, 256, 8, 2) == kp.PrefillPlan(4, (8, 8, 1))
    assert kp.prefill_plan(4, 1, 8, 2) == kp.PrefillPlan(1, (8, 1, 4))
    assert kp.prefill_plan(1, 1, 1, 32) == kp.PrefillPlan(2, (1, 1, 1))
    assert kp.prefill_plan(1, 3, 1, 32) == kp.PrefillPlan(4, (1, 2, 1))


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A library is keyed on its source and every csrc header it includes:
    an edited header gives a new path (a rebuild), an unrelated one does
    not."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "outer.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// v1\n")
    (csrc / "other.cuh").write_text("// v1\n")
    (csrc / "kern.cu").write_text('#include <stdint.h>\n'
                                  '  #include "outer.cuh"\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    assert [p.name for p in build.source_files("kern")] == [
        "kern.cu", "outer.cuh", "inner.cuh"]
    first = build.library_path("kern")
    assert first.parent == tmp_path / "build"
    (csrc / "other.cuh").write_text("// v2\n")
    assert build.library_path("kern") == first
    (csrc / "inner.cuh").write_text("// v2\n")
    second = build.library_path("kern")
    assert second != first
    (csrc / "kern.cu").write_text('#include "outer.cuh"\n')
    assert build.library_path("kern") not in (first, second)


def _decode_need():
    """The largest split-KV workspace qwen3-0.6b's decode needs at 4 slots,
    any window up to its 40,960 positions."""
    return max(kd.decode_plan(4, w, 8, 2, 64).workspace
               for w in range(kd.SEG, 40961, kd.SEG))


# B1's split-K workspace and B3/B5's split-KV one, each with the largest
# need of the model's shapes
WORKSPACE_KINDS = [
    pytest.param(km, lambda: max(km.gemm_plan(m, n, k).workspace
                                 for m in M_ROWS
                                 for k, n in DECODE_KN + RAGGED_KN), id="B1"),
    pytest.param(kd, _decode_need, id="B3"),
]


def _store(mod):
    """A new, empty store like the module's own: its minimum and name."""
    assert mod.WORKSPACES.minimum == mod.WORKSPACE_MIN
    return build.Workspaces(mod.WORKSPACES.what, mod.WORKSPACES.minimum)


@pytest.mark.parametrize("mod,need", WORKSPACE_KINDS)
def test_gemm_workspace_is_made_once_and_never_freed(mod, need):
    """The workspace: the first one holds every split of the model's
    shapes, a smaller need takes the same buffer (its pointer stays put), a
    larger one adds a buffer and keeps the old one alive, for a CUDA graph
    that captured it."""
    dev = torch.device("cpu")
    store = _store(mod)
    first = store.get(dev, 100, capturing=lambda: False)
    assert first.numel() == mod.WORKSPACE_MIN and not first.any()
    again = store.get(dev, need(), capturing=lambda: False)
    assert again.data_ptr() == first.data_ptr()
    big = store.get(dev, mod.WORKSPACE_MIN + 1, capturing=lambda: False)
    assert big.numel() == mod.WORKSPACE_MIN + 1
    bufs = store.made(dev)
    assert len(bufs) == 2 and bufs[0] is first and bufs[1] is big


@pytest.mark.parametrize("mod,need", WORKSPACE_KINDS)
def test_gemm_workspace_does_not_grow_inside_a_capture(mod, need):
    dev = torch.device("cpu")
    store = _store(mod)
    with pytest.raises(RuntimeError, match="capture"):
        store.get(dev, 10, capturing=lambda: True)
    ws = store.get(dev, 10, capturing=lambda: False)
    assert store.get(dev, 10, capturing=lambda: True) is ws
    assert store.get(dev, need(), capturing=lambda: True) is ws
    with pytest.raises(RuntimeError, match="capture"):
        store.get(dev, mod.WORKSPACE_MIN + 1, capturing=lambda: True)
    bufs = store.made(dev)
    assert len(bufs) == 1 and bufs[0] is ws


@pytest.mark.parametrize("w", DECODE_W)
def test_decode_plan_tiles_the_window_in_absolute_segments(w):
    """The grid holds one block per (kv head, segment, slot), with as many
    segments as SEG-position segments at multiples of SEG take to tile
    [0, W): the last one holds position W - 1, none starts at or past W
    (the kernel refuses any other count)."""
    b, hkv, g, hd = 4, 8, 2, 64
    plan = kd.decode_plan(b, w, hkv, g, hd)
    n = plan.segments
    assert plan.grid == (hkv, n, b)
    assert (n - 1) * kd.SEG <= w - 1 < n * kd.SEG
    # whole 64-position tiles, one a warp, in a block of at most 1,024
    assert kd.SEG % kd.BKV == 0 and kd.SEG // kd.BKV * 32 <= 1024


@pytest.mark.parametrize("w", DECODE_W)
def test_decode_segments_do_not_depend_on_the_window(w):
    """A slot's visible positions [0, L] fall in segments 0 .. L // SEG,
    the ones the kernel folds, and every window that holds L has them all
    in its grid: a slot's segments, and so its bits, do not depend on the
    window bucket (windowed == full on the card)."""
    limits = {0, kd.SEG - 1, kd.SEG, kd.SEG + 1, w - 1}
    for limit in sorted(x for x in limits if x < w):
        live = limit // kd.SEG + 1
        for w2 in (x for x in DECODE_W if x > limit):
            assert live <= kd.decode_plan(4, w2, 8, 2, 64).segments


@pytest.mark.parametrize("page_size", PAGE_SIZES)
def test_decode_segment_reads_a_slice_of_the_table(page_size):
    """A paged segment's positions [s·SEG, (s+1)·SEG) lie on at most
    SEG / page_size + 1 pages, however long the table: the kernel looks up
    only those entries. The plan's segments read every entry of a table
    past 40,960 positions."""
    n_blk = 40960 // page_size + 1
    w = n_blk * page_size
    covered = set()
    for s in range(kd.decode_plan(4, w, 8, 2, 64).segments):
        lo, hi = s * kd.SEG, min((s + 1) * kd.SEG, w)
        pages = set(range(lo // page_size, (hi - 1) // page_size + 1))
        assert len(pages) <= kd.SEG // page_size + 1
        covered |= pages
    assert covered == set(range(n_blk))


@pytest.mark.parametrize("b,w,hkv,g,hd", [(4, 64, 8, 2, 64), (4, 256, 8, 2, 64),
                                          (4, 257, 8, 2, 64),
                                          (4, 4096, 8, 2, 64),
                                          (6, 4096, 4, 3, 64),
                                          (6, 1024, 1, 16, 64),
                                          (2, 40960, 8, 2, 128),
                                          (4, 640, 32, 1, 96)])
def test_decode_workspace_covers_every_record(b, w, hkv, g, hd):
    """One segment needs no workspace; more need the tickets and a record
    of B · Hkv · segments · (G·hd + 2G) f32, each padded to 16 bytes. The
    model's decode at 4 slots fits the first workspace up to its 40,960
    positions."""
    plan = kd.decode_plan(b, w, hkv, g, hd)
    if plan.segments == 1:
        assert plan.workspace == 0
        return
    rec = kd.record_floats(g, hd)
    assert rec >= g * hd + 2 * g and rec % 4 == 0
    assert plan.workspace == kd.TICKETS + b * hkv * plan.segments * rec
    assert b * hkv <= kd.TICKETS
    assert _decode_need() <= kd.WORKSPACE_MIN


def test_ptxas_summary_reads_each_kernel():
    """The build keeps nvcc's -Xptxas -v report; its summary names each
    entry function, as the compiler's symbol, with registers and spills."""
    from repro_torch.kernels import build
    gemm = ("_ZN47_GLOBAL__N__d8a7533a_14_int8_matmul_cu_0898312c18int8_"
            "matmul_kernelILi16EEEvPKaS2_")
    quant = "_ZN12_GLOBAL__N_123quantize_rowwise_kernelEPK13__nv_bfloat16"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{gemm}' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers, 16 bytes smem",
        f"ptxas info    : Compiling entry function '{quant}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers, used 1 barriers",
    ])
    assert build.ptxas_summary(log) == [(gemm, 56, 8, 4), (quant, 30, 0, 0)]


def _cuda_head_dims(source: str, pattern: str) -> set:
    text = (build.CSRC / source).read_text()
    return {int(hd) for hd in re.findall(pattern, text)}


def test_head_dims_are_the_cuda_instances():
    """Each wrapper's HEAD_DIMS are exactly the hd instances its CUDA
    source switches on, so a wrapper never passes a width the kernel
    refuses at launch."""
    one = r"case (\d+): return launch_one<"
    assert _cuda_head_dims("decode_attention.cu", one) == set(kd.HEAD_DIMS)
    assert _cuda_head_dims("prefill_attention.cu", one) == set(kd.HEAD_DIMS)
    assert _cuda_head_dims("flash_attention.cu",
                           r"case (\d+): e = launch<") == set(kf.HEAD_DIMS)


@pytest.mark.parametrize("arch", sorted(configs.ARCH_MODULES))
def test_every_published_head_dim_has_an_instance(arch):
    """Every config of the registry that attends, at its published width,
    has a head dim that B3-B6 and B7 take (phi-3-vision's 96 among
    them), and its query heads a kv head within each kernel's G
    limit."""
    cfg = configs.get_config(arch)
    if "attn" not in cfg.pattern:
        return
    hd, g = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    assert hd in kd.HEAD_DIMS and hd in kf.HEAD_DIMS
    assert g <= kd.G_MAX and g <= kp.G_MAX and g <= kf.G_MAX
