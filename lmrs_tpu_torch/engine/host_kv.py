"""Host-RAM and disk KV spill tiers behind the prefix cache (the port of the
reference's ``engine/host_kv.py``).

An HBM eviction of a prefix-cache node no longer throws the KV away: the
victim's page CONTENT is captured device→host into a bounded host-memory
pool (``HostKVPool``) and the radix node stays in the tree as a *spilled*
node; a later match restores the payload into fresh device pages instead of
re-prefilling them (``engine/prefix_cache.py``).  With the disk tier armed
(``DiskKVPool``), host-pool budget pressure demotes the LRU host entry to a
spill file instead of dropping it.

* Both pools are pure accounting over radix nodes (the payload lives on the
  node's ``spill``): bytes used, LRU victims by the node's radix ``tick``
  (one clock across device, host and disk), a ``keep`` set of pinned node
  ids, ``fits`` for an entry against the whole budget, and counters.  Every
  caller runs on the scheduler thread.
* A spill file is the raw k bytes then the v bytes, written to a ``.tmp``
  and renamed, tagged with a crc32 the read checks; a missing, short, torn
  or corrupt file raises ``DiskReadError`` and the caller re-prefills.
  Each pool writes into a fresh subdirectory of its root.
* bfloat16 without ``ml_dtypes``: numpy has no bfloat16, so a bf16 payload
  is carried as raw 2-byte words in the ``BF16`` dtype (``uint16`` tagged
  with the wire name ``"bfloat16"``); ``dtype_name`` gives the name the
  reference writes, so spill descriptors and handoff wires carry the same
  bytes and names in both packages.

Standard library and numpy only.
"""

from __future__ import annotations

import logging
import os
import tempfile
import zlib

import numpy as np

logger = logging.getLogger("lmrs_torch.host_kv")

# raw bfloat16 words: uint16 storage tagged with the wire name
BF16 = np.dtype(np.uint16, metadata={"wire": "bfloat16"})


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype for a wire dtype name (``"bfloat16"`` -> ``BF16``)."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def dtype_name(arr) -> str:
    """The wire dtype name of an array (``"bfloat16"`` for ``BF16``)."""
    meta = arr.dtype.metadata
    if meta and "wire" in meta:
        return meta["wire"]
    return str(arr.dtype)


def as_dtype(arr: np.ndarray, name: str) -> np.ndarray:
    """``arr`` viewed as the wire dtype ``name`` (restores the ``BF16`` tag
    that numpy drops through ``concatenate``)."""
    want = np_dtype(name)
    return arr if arr.dtype == want and dtype_name(arr) == name \
        else arr.view(want)


class DiskReadError(RuntimeError):
    """A disk-tier payload could not be read back (missing, torn or corrupt
    spill file).  Callers degrade to re-prefill, as for a host entry
    dropped between match and prefetch."""


def _victim(entries: dict, keep):
    """The entry with the least radix tick outside ``keep`` (ids)."""
    best = None
    for node, _nbytes in entries.values():
        if keep and id(node) in keep:
            continue
        if best is None or node.tick < best.tick:
            best = node
    return best


class HostKVPool:
    """Bounded host-RAM pool of spilled KV page payloads (accounting only;
    the arrays live on the owning radix nodes)."""

    def __init__(self, budget_bytes: int, disk: "DiskKVPool | None" = None):
        self.budget_bytes = max(0, int(budget_bytes))
        self.used_bytes = 0
        # optional third tier: budget pressure demotes the LRU entry there
        self.disk = disk
        self.entries: dict[int, tuple[object, int]] = {}  # id -> (node, bytes)
        self.spilled_pages_total = 0
        self.prefetched_pages_total = 0
        self.dropped_pages_total = 0

    def __len__(self) -> int:
        return len(self.entries)

    def fits(self, nbytes: int) -> bool:
        """Whether an entry of ``nbytes`` can ever be admitted."""
        return 0 < nbytes <= self.budget_bytes

    def add(self, node, nbytes: int, n_pages: int) -> None:
        """Admit a spilled node (the caller checked ``fits``); the budget
        is enforced by a separate pass over ``victim``."""
        self.entries[id(node)] = (node, int(nbytes))
        self.used_bytes += int(nbytes)
        self.spilled_pages_total += n_pages

    def remove(self, node, n_pages: int = 0, dropped: bool = False) -> None:
        """Forget a node (promotion, subtree drop or budget eviction);
        ``dropped`` counts its pages as lost from the tier."""
        ent = self.entries.pop(id(node), None)
        if ent is None:
            return
        self.used_bytes -= ent[1]
        if dropped:
            self.dropped_pages_total += n_pages

    def note_prefetch(self, n_pages: int) -> None:
        self.prefetched_pages_total += n_pages

    def over_budget(self) -> bool:
        return self.used_bytes > self.budget_bytes

    def victim(self, keep=None):
        """The LRU spilled node outside ``keep``, or None."""
        return _victim(self.entries, keep)

    def stats(self) -> dict:
        out = {
            "host_pool_entries": len(self.entries),
            "host_pool_bytes": self.used_bytes,
            "host_pool_budget_bytes": self.budget_bytes,
            "spilled_pages_total": self.spilled_pages_total,
            "prefetched_pages_total": self.prefetched_pages_total,
            "host_dropped_pages_total": self.dropped_pages_total,
        }
        if self.disk is not None:
            out.update(self.disk.stats())
        return out


class DiskKVPool:
    """Bounded disk tier under the host pool: accounting plus spill-file
    I/O.  A node's payload becomes a *descriptor* dict naming its file."""

    def __init__(self, budget_bytes: int, dir_path: str = ""):
        self.budget_bytes = max(0, int(budget_bytes))
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="lmrs-kvd-", dir=dir_path or None)
        self.used_bytes = 0
        self.entries: dict[int, tuple[object, int]] = {}  # id -> (node, bytes)
        self._seq = 0
        self.demoted_pages_total = 0
        self.promoted_pages_total = 0
        self.dropped_pages_total = 0
        self.read_failures_total = 0
        self.bytes_written_total = 0
        self.bytes_read_total = 0

    def __len__(self) -> int:
        return len(self.entries)

    def fits(self, nbytes: int) -> bool:
        return 0 < nbytes <= self.budget_bytes

    def add(self, node, nbytes: int, n_pages: int) -> None:
        self.entries[id(node)] = (node, int(nbytes))
        self.used_bytes += int(nbytes)
        self.demoted_pages_total += n_pages

    def remove(self, node, n_pages: int = 0, dropped: bool = False) -> None:
        ent = self.entries.pop(id(node), None)
        if ent is None:
            return
        self.used_bytes -= ent[1]
        if dropped:
            self.dropped_pages_total += n_pages

    def note_promote(self, n_pages: int) -> None:
        self.promoted_pages_total += n_pages

    def over_budget(self) -> bool:
        return self.used_bytes > self.budget_bytes

    def victim(self, keep=None):
        return _victim(self.entries, keep)

    def write(self, payload: dict) -> dict:
        """Write a host payload's k/v arrays as one spill file and return
        the descriptor that replaces the node's payload.  Raises
        ``OSError`` on a failed write (the caller drops the entry)."""
        k, v = payload["k"], payload["v"]
        kb = np.ascontiguousarray(k).tobytes()
        vb = np.ascontiguousarray(v).tobytes()
        crc = zlib.crc32(vb, zlib.crc32(kb))
        self._seq += 1
        path = os.path.join(self.dir, f"kv-{self._seq}.bin")
        tmp = path + ".tmp"
        # write, then rename: a crash mid-write leaves a .tmp, never a
        # half-file under the live name
        with open(tmp, "wb") as f:
            f.write(kb)
            f.write(vb)
        os.replace(tmp, path)
        self.bytes_written_total += len(kb) + len(vb)
        return {"disk": True, "path": path, "nbytes": len(kb) + len(vb),
                "k_shape": [int(s) for s in k.shape],
                "v_shape": [int(s) for s in v.shape],
                "k_dtype": dtype_name(k), "v_dtype": dtype_name(v),
                "dtype": payload.get("dtype"), "crc": crc}

    def read(self, desc: dict) -> dict:
        """mmap a spill file back into a host payload (copies: the file may
        go at once).  Raises ``DiskReadError`` on a missing, short, torn or
        corrupt file."""
        path = desc["path"]
        try:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
        except (OSError, ValueError) as e:
            raise DiskReadError(f"disk spill unreadable: {e}") from e
        try:
            if int(mm.shape[0]) != int(desc["nbytes"]):
                raise DiskReadError(
                    f"disk spill torn: {int(mm.shape[0])} bytes on disk, "
                    f"descriptor says {desc['nbytes']}")
            if zlib.crc32(mm) != desc["crc"]:
                raise DiskReadError("disk spill corrupt (crc mismatch)")
            kd = np_dtype(desc["k_dtype"])
            ks = tuple(int(s) for s in desc["k_shape"])
            kn = int(np.prod(ks)) * kd.itemsize
            k = np.frombuffer(mm[:kn], dtype=kd).reshape(ks).copy()
            v = np.frombuffer(mm[kn:], dtype=np_dtype(desc["v_dtype"])) \
                .reshape(tuple(int(s) for s in desc["v_shape"])).copy()
        except ValueError as e:
            # a descriptor/file disagreement the size and crc guards missed
            raise DiskReadError(f"disk spill unparseable: {e}") from e
        finally:
            del mm
        self.bytes_read_total += int(desc["nbytes"])
        return {"k": k, "v": v, "dtype": desc.get("dtype")}

    def free(self, desc: dict) -> None:
        """Delete an entry's spill file; idempotent."""
        try:
            os.unlink(desc["path"])
        except OSError:
            pass

    def stats(self) -> dict:
        return {
            "disk_pool_entries": len(self.entries),
            "disk_pool_bytes": self.used_bytes,
            "disk_pool_budget_bytes": self.budget_bytes,
            "disk_demoted_pages_total": self.demoted_pages_total,
            "disk_promoted_pages_total": self.promoted_pages_total,
            "disk_dropped_pages_total": self.dropped_pages_total,
            "disk_read_failures_total": self.read_failures_total,
        }
