"""Linear speculative decoding: n-gram drafting and exact-distribution
verify (the port of the reference's ``ops/speculative.py``, linear path;
the tree functions are not ported yet).

Drafting needs no draft model: the most recent earlier occurrence of the
history's last n-gram proposes the tokens that followed it.  One
``forward_paged(multi_decode=True)`` over [B, k+1] tokens scores every
draft at once, and ``verify_tokens`` accepts them by the speculative-
sampling rule with a deterministic proposal q = delta(draft): accept
draft_j with probability p_j(draft_j); at the first rejection draw from the
residual (p with the rejected token zeroed, renormalized); when every valid
draft is accepted, draw the bonus token from the model's own p.  The output
distribution is exactly the model's (greedy rows degenerate to "accept
while draft == argmax").

Both functions are batched tensor code with static shapes: they run on the
device inside the scheduler's decode block, with no host sync.
"""

from __future__ import annotations

import torch


def draft_lookup(
    buf: torch.Tensor,       # [B, L] int token history (prompt + generated)
    hist_len: torch.Tensor,  # [B] valid tokens in buf
    k: int,
    pad_id: int = 0,
    n: int = 2,              # n-gram length (EngineConfig.speculate_ngram)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Propose k draft tokens per row by n-gram lookup over the history.

    Finds the most recent position i with ``buf[i : i+n]`` equal to the LAST
    n history tokens and drafts the k tokens that followed it.  Returns
    ``(draft [B, k], n_valid [B])`` (int32); ``n_valid`` is 0 when the row
    has no earlier occurrence or fewer than n tokens, and clips a match near
    the live end to the real history.  Draft slots past ``n_valid`` hold
    ``pad_id``."""
    b, L = buf.shape
    dev = buf.device
    hist_len = hist_len.long()
    w = L - (n - 1)  # candidate n-gram start positions
    idx = torch.arange(w, device=dev)[None, :]
    match = torch.ones((b, w), dtype=torch.bool, device=dev)
    for j in range(n):
        cj = torch.gather(buf, 1, torch.clamp(hist_len - n + j, min=0)[:, None])
        match &= buf[:, j: j + w] == cj
    # exclude the query n-gram itself and anything whose draft window would
    # start at or after the history end
    match &= idx + n < hist_len[:, None]
    has = match.any(dim=1) & (hist_len >= n)
    pos = torch.where(match, idx, torch.full_like(idx, -1)).max(dim=1).values
    start = pos + n  # draft source window; < hist_len whenever has
    # pad by k so a match near the buffer end always has a full window
    bufp = torch.nn.functional.pad(buf, (0, k), value=pad_id)
    cols = torch.clamp(start, min=0)[:, None] + torch.arange(k, device=dev)[None]
    draft = torch.gather(bufp, 1, cols)
    n_valid = torch.where(has, torch.clamp(hist_len - start, 0, k),
                          torch.zeros_like(start))
    draft = torch.where(torch.arange(k, device=dev)[None] < n_valid[:, None],
                        draft, torch.full_like(draft, pad_id))
    return draft.int(), n_valid.int()


def verify_tokens(
    probs: torch.Tensor,    # [B, k+1, V] filtered model distribution per slot
    draft: torch.Tensor,    # [B, k] proposed tokens
    n_valid: torch.Tensor,  # [B] usable draft prefix length
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-sampling acceptance (deterministic proposal).

    Returns ``(emit [B, k+1], count [B])`` (int32): row b's new tokens are
    ``emit[b, :count[b]]`` — the accepted draft prefix plus one token that
    is the residual draw at the rejection slot or the bonus draw when every
    valid draft was accepted; 1 <= count <= k+1.  ``generator`` supplies
    the [B, k] acceptance uniforms first, then the [B, V] uniforms of the
    final draw (a Gumbel-max over log dist)."""
    b, kp1, v = probs.shape
    k = kp1 - 1
    dev = probs.device
    draft = draft.long()
    u = torch.rand((b, k), generator=generator, device=dev)
    p_draft = torch.gather(probs[:, :k], 2, draft[:, :, None])[:, :, 0]
    ok = (u < p_draft) & (torch.arange(k, device=dev)[None] < n_valid[:, None])
    # accepted prefix length: the first failure cuts everything after it
    a = torch.cumprod(ok.int(), dim=1).sum(dim=1)  # [B] in [0, n_valid]
    rows = torch.arange(b, device=dev)
    p_final = probs[rows, a]  # [B, V], the distribution at slot a
    rejected = a < n_valid
    draft_a = torch.gather(draft, 1, torch.clamp(a, max=k - 1)[:, None])[:, 0]
    residual = p_final.clone()
    residual[rows, draft_a] = 0.0
    residual = residual / torch.clamp(residual.sum(-1, keepdim=True), min=1e-20)
    dist = torch.where(rejected[:, None], residual, p_final)
    g = torch.rand((b, v), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(g.clamp_min(1e-20)))
    final = torch.argmax(torch.log(torch.clamp(dist, min=1e-20)) + gumbel, dim=-1)
    slots = torch.arange(kp1, device=dev)[None]
    emit = torch.where(slots < a[:, None],
                       torch.nn.functional.pad(draft, (0, 1)),
                       torch.zeros_like(slots))
    emit = torch.where(slots == a[:, None], final[:, None], emit)
    return emit.int(), (a + 1).int()
