"""Checkpoint corruption fault injection (mirror of
``repro.checkpoint.faults``).

Each injector damages one *committed* checkpoint directory the way a real
storage fault would, so the restore path's integrity layer
(``repro_torch.checkpoint.manager``) can be proven to detect the damage **by
name** and fall back to the previous good checkpoint instead of silently
restoring garbage:

=================  ====================================================
``bit_rot``        flip one byte inside a shard file's array payload
                   (detected: CRC mismatch naming leaf path + rank)
``truncated``      cut a shard file short (detected: unreadable shard
                   naming the rank)
``missing_shard``  delete one rank's shard file outright (detected:
                   missing shard file naming the rank)
``torn_manifest``  overwrite manifest.json with garbage under an intact
                   COMMITTED marker (detected at the directory scan:
                   the step is skipped with a named warning, exactly
                   like a missing commit marker; ``restore`` of that
                   step names manifest.json)
=================  ====================================================

All injectors are deterministic (no randomness), so a check that uses
them replays exactly.
"""
from __future__ import annotations

from pathlib import Path


def _shard_path(step_dir: Path, rank: int) -> Path:
    p = Path(step_dir) / f"shard_{rank:05d}.npz"
    if not p.exists():
        raise FileNotFoundError(f"no shard file for rank {rank} at {p}")
    return p


def flip_byte(path: Path, offset: int) -> None:
    """Flip every bit of the byte at ``offset`` (negative offsets count
    from the end) — the minimal storage fault."""
    path = Path(path)
    data = bytearray(path.read_bytes())
    data[offset] ^= 0xFF
    path.write_bytes(bytes(data))


def inject_bit_rot(step_dir: Path, rank: int = 0) -> str:
    """Flip one byte in the middle of rank ``rank``'s shard file — lands
    in an array payload region (past the zip local headers) for any
    non-trivial state, so restore must fail the checksum, not the zip
    structure parse."""
    p = _shard_path(step_dir, rank)
    flip_byte(p, p.stat().st_size // 2)
    return f"bit_rot(rank={rank})"


def inject_truncated_shard(step_dir: Path, rank: int = 0) -> str:
    """Cut rank ``rank``'s shard file to half its size (a torn write that
    somehow survived the commit protocol, or post-commit media damage)."""
    p = _shard_path(step_dir, rank)
    size = p.stat().st_size
    with open(p, "rb+") as f:
        f.truncate(size // 2)
    return f"truncated(rank={rank})"


def inject_missing_shard(step_dir: Path, rank: int = 0) -> str:
    """Delete rank ``rank``'s shard file outright (lost object / deleted
    blob)."""
    _shard_path(step_dir, rank).unlink()
    return f"missing_shard(rank={rank})"


def inject_torn_manifest(step_dir: Path) -> str:
    """Overwrite manifest.json with unparseable garbage while COMMITTED
    stays intact — the one corruption the directory scan itself must
    absorb (skip + named warning) before restore even starts."""
    (Path(step_dir) / "manifest.json").write_text("{ torn-manifest garbage")
    return "torn_manifest"


# name -> injector(step_dir, rank) for sweep-style proofs; torn_manifest
# ignores the rank argument
CORRUPTIONS = {
    "bit_rot": lambda d, rank=0: inject_bit_rot(d, rank),
    "truncated": lambda d, rank=0: inject_truncated_shard(d, rank),
    "missing_shard": lambda d, rank=0: inject_missing_shard(d, rank),
    "torn_manifest": lambda d, rank=0: inject_torn_manifest(d),
}
