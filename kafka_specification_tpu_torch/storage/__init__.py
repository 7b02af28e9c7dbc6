"""Out-of-core state storage: the disk tier.

The port's own copy of ``kafka_specification_tpu/storage/`` (the
single-device tier, and the sharded engine's per-shard parent log).
The checker's dedup stores form a memory hierarchy:

- **device** — the sorted pair set and the hash table on the card
  (``ops/dedup.py``, ``ops/hashset.py``);
- **host** — the native C++ open-addressing FpSet (``native/``);
- **disk** (this package) — sorted, mmap-read fingerprint runs with a
  bloom + interval filter per run and periodic k-way merges, plus a
  disk-spilled frontier queue (chunked segments consumed in discovery
  order) and an append-only on-disk parent log for counterexample traces.
  This is the tier that takes a run past RAM.

Components:

- `TieredFpSet`   — host FpSet bounded by a byte budget; overflow spills
                    sorted immutable runs to disk, lookups touch disk only
                    on a bloom/interval probable hit (storage/tiered).
- `FrontierWriter`/`FrontierReader` — the disk-spilled frontier queue
                    (storage/frontier).
- `ParentLog`     — level-segmented, CRC-framed parent-pointer log; trace
                    reconstruction reads the log instead of in-RAM parent
                    arrays, so traces survive checkpoint/resume
                    (storage/parent_log).
- `DiskTierStore` — the single-device engine's composition of all three
                    plus the checkpoint-generation deletion barrier
                    (storage/store).

Crash-safety contract: every file is written to a tmp name and atomically
`os.replace`d; run/segment files are immutable once named; deletions are
deferred until `checkpoint_keep` newer checkpoint generations exist, so
every retained generation's manifest resolves; the engine checkpoint
records the storage *manifest* (run names + frontier segment offsets),
never the data itself.  Every file format is the JAX package's, byte for
byte, so a disk-tier checkpoint of either package resumes in the other.
"""

from .bloom import BloomFilter
from .frontier import FrontierReader, FrontierWriter
from .parent_log import ParentLog
from .runs import SortedRun, merge_runs, write_run
from .store import DiskTierStore
from .tiered import DeferredDeleter, TieredFpSet

DEFAULT_MEM_BUDGET = 4 << 30  # bytes of host FpSet residency before spilling


def parse_mem_budget(text) -> int:
    """'512M' / '4G' / '65536' / '1.5G' -> bytes (CLI --mem-budget)."""
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip()
    mult = 1
    suffixes = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1].upper() in suffixes:
        mult = suffixes[s[-1].upper()]
        s = s[:-1]
    try:
        v = float(s)
    except ValueError:
        raise ValueError(f"bad --mem-budget {text!r} (use e.g. 512M, 4G)")
    if v <= 0:
        raise ValueError(f"--mem-budget must be positive, got {text!r}")
    return int(v * mult)


def resolve_store(store: str, mem_budget) -> bool:
    """Map the --store knob to use_disk.  'auto' turns the disk tier on
    exactly when a memory budget was given."""
    if store not in ("auto", "ram", "disk"):
        raise ValueError(f"store must be 'auto', 'ram' or 'disk', got {store!r}")
    if store == "ram":
        return False
    if store == "disk":
        return True
    return mem_budget is not None


__all__ = [
    "BloomFilter",
    "DEFAULT_MEM_BUDGET",
    "DeferredDeleter",
    "DiskTierStore",
    "FrontierReader",
    "FrontierWriter",
    "ParentLog",
    "SortedRun",
    "TieredFpSet",
    "merge_runs",
    "parse_mem_budget",
    "resolve_store",
    "write_run",
]
