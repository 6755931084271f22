"""Launch wrapper of the CUDA fused-sweep kernel (``csrc/fused_sweep.cu``),
the port of the six Pallas fused-sweep kernels of
``repro/kernels/fused_sweep/fused_sweep.py``.

:func:`sweep_streams_cuda` takes the arguments of the plain version
``ref.sweep_streams_ref``, checks what the kernel takes and raises on
anything else, launches one CTA per stream on PyTorch's current stream
and counts the launch in :data:`launches`, under the name of the TPU
kernel the call stands for: ``"fused_sweep"`` (one stream, the serial
sweep), ``"fused_sweep_cells"`` (a round of nomad queues of dense cell
rows), ``"fused_sweep_ragged"`` (a round of ragged nomad streams), and
each of them with ``"_docs"`` appended when ``dto`` pages ``n_td`` (through
a shared-memory slab where the state fits a block, else reading the rows
where they lie).  Where a stream's state does not fit a block's shared
memory, the kernel keeps the rest in device memory (:func:`placement`);
the wrapper allocates the scratch that takes.  It never falls back to the
plain version: ``ops.sweep_streams`` picks the plain version for CPU
tensors.

:func:`slab_of_tokens` is the paged kernel's contract on the slab map,
which the plain version holds too: the wrapper refuses a map the kernel
would follow out of its slab.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["sweep_streams_cuda", "fused_sweep_smem_bytes", "check_topics",
           "check_fits", "placement", "slab_of_tokens", "SMEM_LIMIT_BYTES",
           "MAX_TOPICS", "N_BLK", "launches"]

#: The reference's token tile (``repro/kernels/fused_sweep/fused_sweep.py
#: :114``): the default tile of a doc-tiled stream and the dense layout's
#: doc-tiling grid step.
N_BLK = 256

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448

#: The largest T the kernel takes (``csrc/fused_sweep.cu:kMaxTopics``), in
#: either r-mode with any ``r_cap``, paged or not: the largest power of two
#: the reference's compiled sweep takes (``repro/kernels/fused_sweep/ops.py:
#: fused_vmem_bytes``: a cell of one row, one document and one word fits
#: its VMEM budget at T = 262,144, none at 524,288).
MAX_TOPICS = 262_144

#: The arrays of a stream's state, in the bit order of
#: ``fused_sweep_placement`` (``csrc/fused_sweep.cu:Array``).
_ARRAYS = ("values", "slab", "F", "n_t", "row", "topics", "scan", "root")

#: Kernel launches since the counts were last set to 0, by TPU kernel.
launches = {name + docs: 0
            for name in ("fused_sweep", "fused_sweep_cells",
                         "fused_sweep_ragged")
            for docs in ("", "_docs")}


def fused_sweep_smem_bytes(T: int, cap: int, doc_rows: int = 0,
                           sparse: bool = False) -> int:
    """Shared memory one CTA takes, in bytes, as the kernel places the
    state (``csrc/fused_sweep.cu:layout``, read from the built library):
    where it fits, the F+tree, the ``n_t`` copy, the compacted vector and
    the scan and root scratch, the ``(doc_rows, T)`` slab when paging and
    the token's ``n_td`` row in dense r-mode unpaged; else the spilled
    layout's share (:func:`placement`)."""
    return int(_build.library().fused_sweep_smem_bytes(
        int(T), int(cap), int(doc_rows), int(sparse)))


def placement(T: int, cap: int, doc_rows: int = 0,
              sparse: bool = False) -> dict:
    """Where the kernel keeps a stream's state for ``(T, cap, doc_rows)``
    (``csrc/fused_sweep.cu:layout``, read from the built library):
    ``spill`` is false where it all fits one block's shared memory;
    where it does not, the doc rows are read where they lie in ``n_td``
    (``rows: "in place"``, the paged forms too), and ``shared`` and
    ``device`` name the arrays in shared and in device memory (the F+tree
    in the output row, ``n_t`` in its own row, the tables in a scratch
    slice of ``scratch_bytes`` a stream).  The placement follows from
    these arguments alone."""
    lib = _build.library()
    args = (int(T), int(cap), int(doc_rows), int(sparse))
    mask = int(lib.fused_sweep_placement(*args))
    spill = bool(mask >> len(_ARRAYS) & 1)
    rows = ("in place" if spill or (sparse and not doc_rows)
            else "slab" if doc_rows else "copied")
    held = [(n, mask >> i & 1) for i, n in enumerate(_ARRAYS)
            if n not in ("slab", "row") or rows == {"slab": "slab",
                                                     "row": "copied"}[n]]
    return {"spill": spill, "rows": rows,
            "shared": [n for n, smem in held if smem],
            "device": [n for n, smem in held if not smem],
            "smem_bytes": int(lib.fused_sweep_smem_bytes(*args)),
            "scratch_bytes": int(lib.fused_sweep_scratch_bytes(*args))}


def check_topics(T: int, cap: int, doc_rows: int = 0) -> None:
    """Raise ``ValueError`` unless T is a power of two in ``[1,
    MAX_TOPICS]``, ``cap`` in ``[1, T]`` and ``doc_rows >= 0``: the
    arguments the kernel refuses whatever the placement (read without the
    built library)."""
    if T < 1 or T & (T - 1) or T > MAX_TOPICS:
        raise ValueError(f"the fused-sweep kernel takes a power-of-two T "
                         f"in [1, {MAX_TOPICS}]; got T={T}")
    if not 1 <= cap <= T:
        raise ValueError(f"r_cap must be in [1, T={T}], got {cap}")
    if doc_rows < 0:
        raise ValueError(f"doc_rows must be >= 0, got {doc_rows}")


def check_fits(T: int, cap: int, doc_rows: int = 0,
               sparse: bool = False) -> dict:
    """Raise ``ValueError`` for a ``(T, cap, doc_rows)`` the kernel cannot
    run in the given r-mode (:func:`check_topics`).  Every other one runs:
    where the state does not fit a block's shared memory (T = 16,384 and
    above with ``cap = T``, or a slab of ``doc_rows`` rows past it), the
    kernel keeps what does not fit in device memory.  Returns the
    :func:`placement`."""
    check_topics(T, cap, doc_rows)
    where = placement(T, cap, doc_rows, sparse)
    if where["smem_bytes"] > SMEM_LIMIT_BYTES:      # never below MAX_TOPICS
        raise ValueError(f"the fused-sweep kernel's scan scratch for "
                         f"T={T}, r_cap={cap} ({where['smem_bytes']} B) "
                         f"exceeds the {SMEM_LIMIT_BYTES} B of shared "
                         f"memory a block may use")
    return where


def slab_of_tokens(tok_doc, tok_valid, dto, *, r: int, dtile: int,
                   doc_rows: int, I_max: int, lo: int, hi: int):
    """Stream positions ``[lo, hi)`` of round ``r``'s W streams against
    their slab map ``dto`` ``(W, C, n_dt)`` (one entry per ``dtile``
    positions): each position's slab ``g`` and each token's row in it,
    both ``(W, hi - lo)`` int64.  Raises ``ValueError`` unless every entry
    names a slab of the shard (rows ``[g·doc_rows, min((g+1)·doc_rows,
    I_max))``, at least one of them) and every valid token's doc row lies
    in its slab."""
    W, C, _ = tok_doc.shape
    dev = tok_doc.device
    b = torch.arange(W, device=dev)
    c = (b + r) % C
    pos = torch.arange(lo, hi, device=dev)
    g = dto[b, c].long()[:, pos // dtile]
    off = tok_doc[b, c, lo:hi].long() - g * doc_rows
    height = torch.clamp(I_max - g * doc_rows, max=doc_rows)
    valid = tok_valid[b, c, lo:hi] != 0
    bad_map, bad_tok = torch.stack([
        ((g < 0) | (height < 1)).any(),
        (valid & ((off < 0) | (off >= height))).any()]).tolist()
    if bad_map:
        raise ValueError(f"doc_tile_of names a slab outside the shard of "
                         f"{I_max} rows in slabs of {doc_rows}")
    if bad_tok:
        raise ValueError("a valid token addresses a doc row outside "
                         "the slab its tile's doc_tile_of names")
    return g, off


def sweep_streams_cuda(tok_doc, tok_wrd, tok_valid, tok_bound, z, u, cot,
                       n_td, n_wt, n_t, *, r: int, k: int, tile: int,
                       tile_start: int, num_tiles: int, I_max: int,
                       J_max: int, alpha: float, beta: float,
                       beta_bar: float, cap: int, topics=None, counts=None,
                       dto=None, dtile: int = 0, doc_rows: int = 0,
                       kernel: str = "fused_sweep_ragged") -> torch.Tensor:
    """The kernel on the card; arguments, in-place updates and refusals
    as ``ref.sweep_streams_ref``.  Returns the final F+trees ``(W, 2T)``.
    ``kernel`` (``"fused_sweep"``, ``"fused_sweep_cells"`` or
    ``"fused_sweep_ragged"``) names the launch count it adds to, with
    ``"_docs"`` appended when ``dto`` is given."""
    paged = dto is not None
    if kernel not in launches or kernel.endswith("_docs"):
        raise ValueError(f"kernel must be 'fused_sweep', "
                         f"'fused_sweep_cells' or 'fused_sweep_ragged'; "
                         f"got {kernel!r}")
    kernel += "_docs" if paged else ""
    dev = n_t.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_streams_cuda runs on a CUDA device; n_t is "
                         f"on {dev}")
    named = {"tok_doc": tok_doc, "tok_wrd": tok_wrd,
             "tok_valid": tok_valid, "tok_bound": tok_bound, "z": z,
             "cot": cot, "n_td": n_td, "n_wt": n_wt, "n_t": n_t, "u": u}
    if (topics is None) != (counts is None):
        raise ValueError("topics and counts come together (sparse r-mode)")
    if topics is not None:
        named.update(topics=topics, counts=counts)
    if paged:
        named.update(dto=dto)
    for name, x in named.items():
        want = torch.float32 if name == "u" else torch.int32
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, n_t on {dev}")
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tok_doc.ndim != 3:
        raise ValueError(f"token arrays must be (W, C, S); got "
                         f"{tuple(tok_doc.shape)}")
    W, C, S = tok_doc.shape
    T = n_t.shape[-1]
    n_tiles = cot.shape[-1]
    for name in ("tok_wrd", "tok_valid", "tok_bound", "z"):
        if named[name].shape != tok_doc.shape:
            raise ValueError(f"{name} {tuple(named[name].shape)} must match "
                             f"tok_doc {tuple(tok_doc.shape)}")
    if tuple(u.shape) != (W, S) or tuple(cot.shape) != (W, C, n_tiles):
        raise ValueError(f"u must be (W, S) = {(W, S)} and cot (W, C, "
                         f"n_tiles); got {tuple(u.shape)}, "
                         f"{tuple(cot.shape)}")
    if tuple(n_t.shape) != (W, T) or n_td.shape != (W * I_max, T) \
            or n_wt.ndim != 2 or n_wt.shape[1] != T:
        raise ValueError(f"n_t (W, T), n_td (W·I_max, T), n_wt (B·J_max, "
                         f"T) expected; got {tuple(n_t.shape)}, "
                         f"{tuple(n_td.shape)}, {tuple(n_wt.shape)}")
    if topics is not None and (topics.shape != (W * I_max, cap)
                               or counts.shape != topics.shape):
        raise ValueError(f"side tables must be (W·I_max, cap) = "
                         f"{(W * I_max, cap)}; got {tuple(topics.shape)}")
    if tile < 1 or n_tiles * tile > S or tile_start < 0 or num_tiles < 0 \
            or tile_start + num_tiles > n_tiles:
        raise ValueError(f"tiles [{tile_start}, {tile_start + num_tiles}) "
                         f"of {tile} tokens do not fit a {n_tiles}-tile "
                         f"stream of {S}")
    n_dt = 0
    if paged:
        n_dt = dto.shape[-1]
        if dto.ndim != 3 or tuple(dto.shape[:2]) != (W, C) or dtile < 1 \
                or n_dt * dtile < (tile_start + num_tiles) * tile \
                or doc_rows < 1:
            raise ValueError(f"dto must be (W, C, n_dt) = ({W}, {C}, ·) "
                             f"with n_dt·dtile covering the tiles and "
                             f"doc_rows >= 1; got {tuple(dto.shape)}, "
                             f"dtile={dtile}, doc_rows={doc_rows}")
    else:
        dtile = doc_rows = 0
    sparse = topics is not None
    where = check_fits(T, cap, doc_rows, sparse)
    if paged and num_tiles:
        slab_of_tokens(tok_doc, tok_valid, dto, r=r, dtile=dtile,
                       doc_rows=doc_rows, I_max=I_max, lo=tile_start * tile,
                       hi=(tile_start + num_tiles) * tile)
    F = torch.empty((W, 2 * T), dtype=torch.float32, device=dev)
    scratch = None
    if where["scratch_bytes"]:
        scratch = torch.empty((W, where["scratch_bytes"] // 4),
                              dtype=torch.int32, device=dev)
    ptr = lambda x: x.data_ptr() if x is not None else 0
    _build.launch(
        "fused_sweep_launch", tok_doc.data_ptr(), tok_wrd.data_ptr(),
        tok_valid.data_ptr(), tok_bound.data_ptr(), z.data_ptr(),
        u.data_ptr(), cot.data_ptr(), ptr(dto), n_td.data_ptr(),
        n_wt.data_ptr(), n_t.data_ptr(), F.data_ptr(), ptr(topics),
        ptr(counts), ptr(scratch), W, C, S, n_tiles, tile, tile_start,
        num_tiles, int(r),
        int(k), int(I_max), int(J_max), T, int(cap), int(dtile), n_dt,
        int(doc_rows), float(alpha), float(beta), float(beta_bar),
        torch.cuda.current_stream(dev).cuda_stream)
    launches[kernel] += 1
    return F
