"""Self-speculative decoding: the HQP artifact drafts, its bf16 parent
verifies.

HQP's accuracy bound is what makes the compressed artifact a drafter its
own parent accepts often: the drafter proposes k cheap tokens, the
verifier scores all k+1 positions in one ``lm.verify_step`` pass (the
prefill route), and acceptance keeps every emitted token distributed as
the verifier alone would have drawn it; greedy, it is the verifier's own
token, so the output equals serial decode of the verifier whose one-token
steps take the prefill route (see ``SpecDecoder`` on the decode route).

One dispatch runs ``cycles`` cycles on the device with no host round trip
between them; each cycle:

  draft    a 2-token healing chunk ``[prev, t0]`` at pos-1 on the prefill
           route (it rewrites pos-1, or fills the one position the
           drafter skipped when every draft of the last cycle was
           accepted), then k-1 decode steps over the drafter's own pool;
  verify   one ``verify_step`` over ``[t0, d1..dk]`` at pos;
  accept   greedy: the longest prefix of drafts equal to the verifier's
           argmax, then the verifier's own token; sampled: draft d kept
           with probability min(1, p(d)/q(d)), a rejection resampled from
           max(p - q, 0) normalised, the bonus drawn from p;
  emit     a prefix of the k+1 candidates, cut at EOS and the budget;
  rollback both pools' ``pos`` to the emitted length (the stale K/V past
           it stays masked until a later write replaces it).

Rows that are not live at dispatch (free slots, slots mid-prefill) would
write behind their position (the healing chunk writes at pos-1). They are
parked: their position is set to ``park_position(max_seq)`` for the
dispatch and put back after it, so their writes land on the trash page
(paged, their table rows point there) or in ``pool_margin(k)`` positions
past ``max_seq`` that a contiguous speculative pool carries and no attend
reads. A row that stops mid-dispatch runs the remaining cycles without
emitting: its healing chunk rewrites the drafter's entry at pos-1 with
the same token, and every other write lands at or past its rolled-back
``pos``.

Rolling back by ``pos`` needs position-indexed caches, so patterns with
recurrent blocks are refused."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.compress.artifact import arch_fingerprint
from repro_torch.models import lm
from repro_torch.serving import prng
from repro_torch.serving import sampling as smp
from repro_torch.serving import state_pool as sp


def check_drafter_compat(cfg, manifest) -> None:
    """Refuse a drafter artifact built for another model before any device
    work. ``manifest`` is an ``HQPManifest``, or None to skip (a drafter
    built here from the verifier's own params). A manifest without a hash
    is checked on its vocab alone, when it recorded one."""
    if manifest is None:
        return
    want = arch_fingerprint(cfg)
    if manifest.arch_hash is not None and manifest.arch_hash != want:
        raise ValueError(
            f"drafter artifact arch_hash {manifest.arch_hash!r} (built for "
            f"{manifest.arch!r}) does not match the verifier config "
            f"{cfg.name!r} (fingerprint {want!r}): a speculative drafter "
            f"must share its verifier's vocab and architecture")
    if manifest.vocab_size is not None and manifest.vocab_size != \
            cfg.vocab_size:
        raise ValueError(
            f"drafter artifact vocab_size {manifest.vocab_size} != verifier "
            f"vocab_size {cfg.vocab_size}: draft token ids would not be "
            f"verifier token ids")


def park_position(max_seq: int) -> int:
    """Where rows not live in a dispatch sit during it: past every window,
    so they attend nothing any live row wrote and their own writes go past
    ``max_seq``."""
    return max_seq + 1


def pool_margin(k: int) -> int:
    """Positions a contiguous speculative pool keeps past ``max_seq`` for
    the writes of parked rows: pos-1 through pos+k of a cycle at
    ``park_position``."""
    return k + 2


def accept_sampled(p: torch.Tensor, q: torch.Tensor, drafts: torch.Tensor,
                   pos: torch.Tensor, base: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Modified rejection sampling. p (B, k+1, V) the verifier's and q (B,
    k, V) the drafter's post-warp distributions, drafts (B, k), pos (B,)
    the position of the chunk's first token. Draft i (at pos + 1 + i) is
    accepted when u * q(d) <= p(d), u uniform keyed on ``LANE_ACCEPT`` at
    its position. Returns (accepted prefix length (B,), the correction
    token at each of the k+1 positions (B, k+1)): at i < k a draw from
    max(p - q, 0) normalised, which falls back to p where p - q has no
    positive mass (read only after a rejection, but 0/0 must not exist
    even there); at i = k a draw from p. Correction i is keyed on
    ``LANE_RESIDUAL`` at pos + 1 + i."""
    k = drafts.shape[1]
    steps = torch.arange(k + 1, device=pos.device)
    cpos = pos.long()[:, None] + 1 + steps[None, :]          # (B, k+1)
    u = prng.uniform(smp.token_key(base, cpos[:, :k], smp.LANE_ACCEPT))
    p_d = torch.gather(p[:, :k], -1, drafts[..., None])[..., 0]
    q_d = torch.gather(q, -1, drafts[..., None])[..., 0]
    accept = (u * q_d <= p_d).long()
    n_acc = torch.cumprod(accept, dim=1).sum(dim=1)
    res = torch.clamp_min(p[:, :k] - q, 0.0)
    rsum = res.sum(dim=-1, keepdim=True)
    res = torch.where(rsum > 0, res / torch.clamp_min(rsum, 1e-30), p[:, :k])
    cdist = torch.cat([res, p[:, k:]], dim=1)
    corr = prng.categorical(smp.token_key(base, cpos, smp.LANE_RESIDUAL),
                            torch.log(cdist))
    return n_acc, corr


class SpecDecoder:
    """The drafter and verifier params and the speculative dispatch.

    ``dispatch`` runs ``cycles`` cycles of ``k`` drafts each over the
    drafter pool ``dpool`` and the verifier pool ``vpool`` in place,
    reading its inputs from one (5, B) int64 device buffer (the token at
    pos-1 and the pending token of each slot, live flags, EOS ids (-1 =
    none), tokens each slot may still emit) and writing its results into
    one fixed output buffer: no host sync, so it can run as a CUDA graph.
    In the paged layout one page table addresses both arenas (the pools'
    positions stay equal), and the engine points rows not live at the
    trash page.

    Greedy output equals serial decode of the verifier whose one-token
    steps take the prefill route, bit for bit: the verify pass gives
    position i the bits of a one-query prefill there (``verify_step``).
    Against one-token steps on the decode route it can differ only where
    the two attention kernels round differently and the verifier's top two
    logits nearly tie; on the CPU plain versions the two routes are the
    same arithmetic.

    The sampling seed is fixed per decoder: its key is made here, once,
    and a captured dispatch reads it as a fixed buffer."""

    def __init__(self, cfg, draft_params: Any, verify_params: Any,
                 k: int = 4, cycles: int = 1,
                 sampling: Optional[smp.SamplingConfig] = None,
                 draft_manifest=None):
        if k < 1:
            raise ValueError(f"spec k must be >= 1, got {k}")
        if cycles < 1:
            raise ValueError(f"spec cycles must be >= 1, got {cycles}")
        recurrent = set(cfg.pattern) - {"attn"}
        if recurrent:
            raise NotImplementedError(
                f"speculative decoding rolls caches back by pos, which only "
                f"position-indexed KV caches support; the pattern has "
                f"recurrent blocks {sorted(recurrent)}")
        check_drafter_compat(cfg, draft_manifest)
        dev = lm.params_device(verify_params)
        if lm.params_device(draft_params) != dev:
            raise ValueError(f"drafter params lie on "
                             f"{lm.params_device(draft_params)}, the "
                             f"verifier's on {dev}")
        self.cfg = cfg
        self.k = k
        self.cycles = cycles
        self.draft_params = draft_params
        self.verify_params = verify_params
        self.sampling = sampling or smp.GREEDY
        self.base = smp.base_key(self.sampling, dev)
        self.last_plan: Optional[Tuple[int, int]] = None

    def plan(self, max_pos: int, max_seq: int,
             max_budget: int) -> Tuple[int, int]:
        """A dispatch's ``(k_eff, cycles_eff)``, capped two ways:

        * in bounds: no write may pass ``max_seq - 1`` (on the card an
          out-of-range KV write is an error); C cycles write at most
          ``C * (k + 1)`` positions past ``max_pos``;
        * right-sized: ``max_budget``, the most tokens a live slot may
          still emit, bounds the useful work, so the last dispatches of a
          request shrink instead of drafting tokens nobody can emit.

        ``k_eff >= 1``: a live slot has budget >= 1, and ``submit`` keeps
        prompt + budget within ``max_seq``. The plan is kept as
        ``last_plan``."""
        avail = max_seq - 1 - max_pos
        k_eff = max(1, min(self.k, avail, max_budget))
        cyc = max(1, min(self.cycles, (avail + 1) // (k_eff + 1),
                         -(-max_budget // (k_eff + 1))))
        self.last_plan = (k_eff, cyc)
        return k_eff, cyc

    def n_plans(self) -> int:
        """The (k_eff, cycles_eff) pairs ``plan`` can return, at most."""
        return self.k * self.cycles

    # -------------------------------------------------------------- dispatch
    def dispatch(self, dpool: dict, vpool: dict,
                 table: Optional[torch.Tensor], inputs: torch.Tensor,
                 out: torch.Tensor, k: int, cycles: int, window: int,
                 park: int) -> None:
        """``cycles`` cycles of ``k`` drafts over every slot, in place. Rows
        not live at dispatch sit at ``park`` meanwhile and get their
        positions back after it. Writes into ``out`` ((2 T + 2, B) int64,
        T = cycles * (k + 1)): rows [0, T) the tokens in each slot's
        emission order, [T, 2 T) their emitted flags, 2 T the accepted
        drafts among the emitted tokens, 2 T + 1 the drafts proposed to
        each slot while it was live."""
        prev, tokens = inputs[0][:, None], inputs[1][:, None]
        active, eos, budget = inputs[2] != 0, inputs[3], inputs[4]
        dsaved = sp.park_slots(dpool, active, park)
        vsaved = sp.park_slots(vpool, active, park)
        live = active
        outs, emits, n_acc, drafted = [], [], 0, 0
        for _ in range(cycles):
            (prev, tokens, live, budget, toks, emit, acc, dr) = self._cycle(
                dpool, vpool, table, prev, tokens, live, eos, budget, k,
                window)
            outs.append(toks)
            emits.append(emit)
            n_acc, drafted = n_acc + acc, drafted + dr
        sp.select_slots(dpool, dsaved, active)
        sp.select_slots(vpool, vsaved, active)
        b = inputs.shape[1]
        # (C, B, k+1) -> (C * (k+1), B): each slot's tokens in order
        order = lambda xs: torch.stack(xs).permute(0, 2, 1).reshape(-1, b)
        out.copy_(torch.cat([order(outs), order(emits).long(),
                             n_acc[None], drafted[None]]))

    def _cycle(self, dpool, vpool, table, prev, tokens, live, eos, budget,
               k: int, window: int):
        """One draft -> verify -> accept -> rollback cycle. ``live`` (B,)
        are the rows still running; a row that stopped in an earlier cycle
        emits nothing, and its pos rolls back to where it stopped."""
        cfg, scfg = self.cfg, self.sampling
        greedy = scfg.is_greedy
        pages = {} if table is None else {"pages": table}
        pos = vpool["pos"].clone()
        b = tokens.shape[0]

        def pick(logits, at):
            lg = logits[:, -1]
            if greedy:
                return torch.argmax(lg, dim=-1), None
            return (smp.sample_batch(lg, scfg, self.base, at),
                    smp.probs(lg, scfg))

        # ---- draft: the healing chunk, then k - 1 decode steps
        logits, dst = lm.decode_step(
            self.draft_params, cfg,
            {"caches": dpool["caches"], "pos": dpool["pos"] - 1, **pages},
            torch.cat([prev, tokens], dim=1), window=window, route="prefill")
        d, q = pick(logits, dst["pos"])
        drafts, qs = [d], [q]
        tok = torch.where(live, d, tokens[:, 0])[:, None]
        for _ in range(k - 1):
            logits, dst = lm.decode_step(
                self.draft_params, cfg,
                {"caches": dpool["caches"], "pos": dst["pos"], **pages},
                tok, window=window, route="decode")
            d, q = pick(logits, dst["pos"])
            drafts.append(d)
            qs.append(q)
            tok = torch.where(live, d, tok[:, 0])[:, None]
        d_bk = torch.stack(drafts, dim=1)                       # (B, k)

        # ---- verify: one pass of the verifier over [t0, d1..dk]
        vlogits, _ = lm.verify_step(
            self.verify_params, cfg,
            {"caches": vpool["caches"], "pos": pos, **pages},
            torch.cat([tokens, d_bk], dim=1), window=window)

        # ---- accept
        if greedy:
            corr = torch.argmax(vlogits, dim=-1)                # (B, k+1)
            n_acc = torch.cumprod((d_bk == corr[:, :k]).long(),
                                  dim=1).sum(dim=1)
        else:
            n_acc, corr = accept_sampled(smp.probs(vlogits, scfg),
                                         torch.stack(qs, dim=1), d_bk, pos,
                                         self.base)

        # ---- emit a prefix, cut at EOS and the budget
        i_idx = torch.arange(k + 1, device=pos.device)[None, :]
        d_pad = torch.cat([d_bk, d_bk.new_zeros((b, 1))], dim=1)
        cand = torch.where(i_idx < n_acc[:, None], d_pad, corr)
        prefix = (live[:, None] & (i_idx <= n_acc[:, None])
                  & (i_idx < budget[:, None]))
        eos_hit = (eos[:, None] >= 0) & (cand == eos[:, None]) & prefix
        hits = eos_hit.long()
        emit = prefix & (torch.cumsum(hits, dim=1) - hits == 0)
        n_emit = emit.sum(dim=1)
        n_acc_emit = (emit & (i_idx < n_acc[:, None])).sum(dim=1)

        # ---- rollback every row, and the next cycle's carries
        pos_new = pos + n_emit
        sp.rollback_slots(dpool, pos_new)
        sp.rollback_slots(vpool, pos_new)
        last = torch.gather(cand, 1, torch.clamp(n_emit - 1, 0, k)[:, None])
        before = torch.gather(cand, 1,
                              torch.clamp(n_emit - 2, 0, k)[:, None])
        tokens2 = torch.where(n_emit[:, None] >= 1, last, tokens)
        prev2 = torch.where(n_emit[:, None] >= 2, before,
                            torch.where(n_emit[:, None] == 1, tokens, prev))
        stopped = (eos_hit & emit).any(dim=1) | (budget - n_emit <= 0)
        drafted = live.long() * k
        return (prev2, tokens2, live & ~stopped, budget - n_emit,
                torch.where(emit, cand, 0), emit, n_acc_emit, drafted)
