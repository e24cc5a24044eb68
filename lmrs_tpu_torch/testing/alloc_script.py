"""Seeded page-allocator op scripts: one script, replayed on any allocator
with ``PageAllocator``'s contract, must give the same outcomes.

``make_script`` draws alloc / free / incref / refcount / free-count
operations from a seed and runs them on the port's Python allocator as
it goes, so each call is chosen against the pool's real state: frees and
increfs of held pages, allocations up to past the free list
(``OutOfPages``), and a share of calls that must be refused (a double
free, an incref of a free page, the reserved page 0, an id past the
pool).  ``replay`` runs a script on another allocator and returns its
outcomes: the pages an ``alloc`` handed out, ``refcount`` / ``free_count``
values, ``None`` for a free or an incref, or the name of the exception
raised.
"""

from __future__ import annotations

import random

Op = tuple[str, object]


def replay(alloc, script: list[Op]) -> list:
    """Each operation's outcome on ``alloc`` (see the module doc)."""
    out: list = []
    for op, arg in script:
        try:
            if op == "alloc":
                r = alloc.alloc(arg)
            elif op == "free":
                r = alloc.free(arg)
            elif op == "incref":
                r = alloc.incref(arg)
            elif op == "refcount":
                r = alloc.refcount(arg)
            else:
                r = alloc.free_count
        except (ValueError, RuntimeError) as e:  # OutOfPages is a RuntimeError
            r = type(e).__name__
        out.append(r)
    return out


def make_script(seed: int, n_ops: int, num_pages: int
                ) -> tuple[list[Op], list]:
    """``(script, outcomes)``: ``n_ops`` operations over a pool of
    ``num_pages`` and their outcomes on the port's Python allocator."""
    from lmrs_tpu_torch.engine.kv_cache import PageAllocator

    rng = random.Random(seed)
    model = PageAllocator(num_pages)
    held: list[int] = []  # one entry per reference the script holds
    script: list[Op] = []
    outcomes: list = []
    kinds = ("alloc", "free", "incref", "refcount", "free_count", "bad")
    probs = (0.34, 0.34, 0.14, 0.08, 0.04, 0.06)
    for _ in range(n_ops):
        kind = rng.choices(kinds, probs)[0]
        if kind == "alloc":
            op: Op = ("alloc", rng.randrange(9))
        elif kind in ("free", "incref") and held:
            k = rng.randint(1, min(len(held), 6))
            op = (kind, rng.sample(held, k))
        elif kind == "refcount":
            op = ("refcount", rng.randrange(num_pages))
        elif kind == "free_count":
            op = ("free_count", None)
        else:  # a call that must be refused, or free/incref with none held
            bad = rng.choice([0, num_pages, rng.randrange(1, num_pages)])
            op = (rng.choice(("free", "incref")),
                  [bad] + ([bad] if bad and rng.random() < 0.5 else []))
        r = replay(model, [op])[0]
        if not isinstance(r, str):
            if op[0] == "alloc":
                held.extend(r)
            elif op[0] == "incref":
                held.extend(op[1])
            elif op[0] == "free":
                for p in op[1]:
                    held.remove(p)
        script.append(op)
        outcomes.append(r)
    return script, outcomes
