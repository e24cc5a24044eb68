"""Speculative decoding: n-gram drafting and exact-distribution verify,
linear and tree (the port of the reference's ``ops/speculative.py``).

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

Tree speculation (``draft_tree_lookup``, ``verify_tree``): the ``width``
most recent matches each draft a chain, the chains branch at the root, and
one span dispatch whose attention follows ancestor bitmasks scores every
node; acceptance picks a chain by sequential multi-candidate rejection at
the root and then walks it by the linear rule, which again keeps the
model's distribution exactly.

Every function is batched tensor code with static shapes: they run on the
device inside the scheduler's dispatches, with no host sync.  Random draws
come from the caller's ``torch.Generator``.
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


def draft_tree_lookup(
    buf: torch.Tensor,       # [B, L] int token history (prompt + generated)
    hist_len: torch.Tensor,  # [B] valid tokens in buf
    k: int,                  # chain depth (tokens per chain)
    width: int,              # chains per row (tree branching at the root)
    pad_id: int = 0,
    n: int = 2,
    depth: torch.Tensor | None = None,  # [B] per-row depth clamp (adaptive)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Propose a token TREE per row: the ``width`` most recent n-gram
    matches each draft a depth-``k`` continuation chain, branching at the
    root (chain token 0's parent is the current token, chain token j's is
    chain token j-1).  Returns ``(chains [B, width, k], n_valid [B,
    width])`` (int32), most recent match first; ``depth`` clamps each row's
    chains; a chain whose FIRST token repeats a more recent live chain's is
    dropped (``n_valid`` 0: under sequential rejection a duplicate root
    candidate has no residual mass left).  Slots past ``n_valid`` hold
    ``pad_id``."""
    b, L = buf.shape
    dev = buf.device
    hist_len = hist_len.long()
    w = L - (n - 1)
    idx = torch.arange(w, device=dev)[None, :]
    match = torch.ones((b, w), dtype=torch.bool, device=dev)
    for j in range(n):
        cj = torch.gather(buf, 1, torch.clamp(hist_len - n + j, min=0)[:, None])
        match &= buf[:, j: j + w] == cj
    match &= idx + n < hist_len[:, None]
    # the `width` most recent match positions, descending (-1: none)
    pos = torch.topk(torch.where(match, idx, torch.full_like(idx, -1)),
                     width, dim=1).values
    has = (pos >= 0) & (hist_len[:, None] >= n)
    start = pos + n
    bufp = torch.nn.functional.pad(buf, (0, k), value=pad_id)
    cols = (torch.clamp(start, min=0)[:, :, None]
            + torch.arange(k, device=dev)[None, None])
    chains = torch.gather(bufp, 1, cols.reshape(b, -1)).reshape(b, width, k)
    n_valid = torch.where(has, torch.clamp(hist_len[:, None] - start, 0, k),
                          torch.zeros_like(start))
    if depth is not None:
        n_valid = torch.minimum(n_valid, depth.long()[:, None])
    for c2 in range(1, width):  # dedup root candidates, most recent kept
        dup = torch.zeros((b,), dtype=torch.bool, device=dev)
        for c1 in range(c2):
            dup |= (chains[:, c2, 0] == chains[:, c1, 0]) & (n_valid[:, c1] > 0)
        n_valid[:, c2] = torch.where(dup, torch.zeros_like(n_valid[:, c2]),
                                     n_valid[:, c2])
    chains = torch.where(torch.arange(k, device=dev)[None, None] < n_valid[:, :, None],
                         chains, torch.full_like(chains, pad_id))
    return chains.int(), n_valid.int()


def verify_tree(
    probs: torch.Tensor,    # [B, 1 + W*k, V] filtered model dist per node
    chains: torch.Tensor,   # [B, W, k] proposed chains (draft_tree_lookup)
    n_valid: torch.Tensor,  # [B, W] usable depth per chain
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-distribution tree acceptance (deterministic proposals).  Node
    0 is the current token's output (the root distribution), node ``1 +
    c*k + j`` the output after chain c's token j.  At the root, sequential
    multi-candidate rejection over the chains' first tokens: accept chain c
    with probability residual(x_c), else zero x_c and renormalize (greedy
    rows pick the chain whose first token is the argmax); within the
    winning chain, ``verify_tokens``' rule.

    Returns ``(emit [B, k+1], count [B], chain [B], depth [B])`` (int32):
    row b's new tokens are ``emit[b, :count[b]]``, ``chain`` the winning
    chain (-1 when every root candidate was rejected) and ``depth`` the
    accepted draft tokens (count - 1).  ``generator`` supplies the [B, W]
    root uniforms, then the [B, k] chain uniforms, then the [B, V] uniforms
    of the final draw (a Gumbel-max over log dist)."""
    b, _, v = probs.shape
    _, width, k = chains.shape
    dev = probs.device
    chains, n_valid = chains.long(), n_valid.long()
    u_root = torch.rand((b, width), generator=generator, device=dev)
    u_chain = torch.rand((b, k), generator=generator, device=dev)
    rows = torch.arange(b, device=dev)
    # root: sequential rejection over the candidates' first tokens
    residual = probs[:, 0]
    chosen = torch.full((b,), -1, dtype=torch.long, device=dev)
    for c in range(width):
        x = chains[:, c, 0]
        live = (n_valid[:, c] > 0) & (chosen < 0)
        acc = live & (u_root[:, c] < residual[rows, x])
        chosen = torch.where(acc, torch.full_like(chosen, c), chosen)
        zeroed = residual.clone()
        zeroed[rows, x] = 0.0
        zeroed = zeroed / torch.clamp(zeroed.sum(-1, keepdim=True), min=1e-20)
        residual = torch.where((live & ~acc)[:, None], zeroed, residual)
    # the winning chain's tokens, depth and node distributions
    cs = torch.clamp(chosen, min=0)
    ctoks = chains[rows, cs]                                      # [B, k]
    cvalid = n_valid[rows, cs]                                    # [B]
    off = 1 + cs[:, None] * k + torch.arange(k, device=dev)[None]
    cprobs = probs[rows[:, None], off]                            # [B, k, V]
    # within the chain: token j (j >= 1) against node j-1's distribution
    p_next = torch.gather(cprobs[:, : k - 1], 2, ctoks[:, 1:, None])[:, :, 0]
    ok = ((u_chain[:, : k - 1] < p_next)
          & (torch.arange(1, k, device=dev)[None] < cvalid[:, None]))
    a = 1 + torch.cumprod(ok.int(), dim=1).sum(dim=1)
    a = torch.minimum(a, torch.clamp(cvalid, min=1))  # accepted, in [1, cv]
    # the final token: residual at the rejection node, bonus on full accept
    p_fin = cprobs[rows, a - 1]
    tok_a = ctoks[rows, torch.clamp(a, max=k - 1)]
    resid = p_fin.clone()
    resid[rows, tok_a] = 0.0
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-20)
    dist = torch.where((a < cvalid)[:, None], resid, p_fin)
    none = chosen < 0  # every root candidate rejected: the root residual
    dist = torch.where(none[:, None], residual, dist)
    g = torch.rand((b, v), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(g.clamp_min(1e-20)))
    final = torch.argmax(torch.log(torch.clamp(dist, min=1e-20)) + gumbel, dim=-1)
    acc_n = torch.where(none, torch.zeros_like(a), a)
    slots = torch.arange(k + 1, device=dev)[None]
    emit = torch.where(slots < acc_n[:, None],
                       torch.nn.functional.pad(ctoks, (0, 1)),
                       torch.zeros_like(slots))
    emit = torch.where(slots == acc_n[:, None], final[:, None], emit)
    return emit.int(), (acc_n + 1).int(), chosen.int(), acc_n.int()


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
