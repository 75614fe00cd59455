"""The in-process halo exchange as one launch a phase
(``lbm_exchange_copy``, ``csrc/lbm_ipc.cu``) on the CPU.

The kernel copies every piece of one phase at once from a device table
(``halo.copy_rows``): per piece a source and a destination view, strided.
Here a torch emulation of its indexing (each element e of a piece as
``(plane, row, column)`` of its shape, both addresses from the row's
pointers and strides; every piece's values gathered before any is written,
as a launch that runs them at once would) applies each phase's table to
buffers that are views of one flat tensor, and must give the bits of the
``Tensor.copy_`` list, the kernel's plain version, for every mesh of
``tests/test_torch_sharded.py`` and both exchange kinds (the halo of the
one-step and temporal layouts, the x-tiled route's ghost rows).  The check
that refuses a table whose destinations overlap a source or each other
fires on crafted pieces.  The kernel itself runs on the card, where
``chip_smoke.py`` holds it bitwise against its copy list on every phase of
its runs; its test here skips without one.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import fused
from lbm_tpu_torch.parallel import halo
from lbm_tpu_torch.parallel.halo import (
    GhostExchange,
    HaloExchange,
    SlabLayout,
    TileLayout,
    check_disjoint,
    copy_rows,
)

MESHES = [(1, 1), (2, 1), (8, 1), (2, 4), (4, 2), (1, 4)]


def _pool(shapes, seed):
    """Seeded views of one flat float32 tensor, one a shape, and the
    tensor."""
    sizes = [int(np.prod(s)) for s in shapes]
    gen = torch.Generator().manual_seed(seed)
    pool = torch.rand(sum(sizes) + 7, generator=gen)
    views, at = [], 3  # views off the allocation's start
    for shape, n in zip(shapes, sizes):
        views.append(pool[at:at + n].view(shape))
        at += n
    return pool, views


def _emulate(rows, pool):
    """One launch of the kernel on ``pool`` in torch: each piece's element
    e at ``(e // (rows*cols), e // cols % rows, e % cols)``, every value
    read before any is written."""
    base, item = pool.data_ptr(), pool.element_size()
    gathered = []
    for src, s0, s1, s2, dst, d0, d1, d2, planes, nrows, cols, pad in rows:
        assert pad == 0 and (src - base) % item == 0 and (dst - base) % item == 0
        e = torch.arange(planes * nrows * cols)
        k, rem = e // (nrows * cols), e % (nrows * cols)
        r, c = rem // cols, rem % cols
        si = (src - base) // item + k * s0 + r * s1 + c * s2
        di = (dst - base) // item + k * d0 + r * d1 + c * d2
        gathered.append((di, pool[si].clone()))
    for di, values in gathered:
        pool[di] = values


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _check_exchange(make, pool):
    """The exchange made on ``pool``'s views (``make()``), its phases in
    order through the emulated kernel, against its copy list on a copy of
    the pool's values."""
    ex = make()
    want = pool.clone()
    for ph in ex.phases:
        halo.copy_plain(ph)
    plain, pool[:] = pool.clone(), want
    for ph in ex.phases:
        assert ph.table is None  # on the CPU the copy list runs
        _emulate(copy_rows(ph.copies), pool)
    assert _same_bits(pool, plain)
    assert not _same_bits(plain, want)  # the exchange moved something
    return ex


@pytest.mark.parametrize("halo_width", [1, 2], ids=["one-step", "temporal"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_halo_table_equals_copy_list(mesh, halo_width):
    """Every tile's halo, y phase then x phase (the corners ride along)."""
    py, px = mesh
    layout = TileLayout(16 // py if py < 8 else 2, 32 // px, halo_width)
    pool, views = _pool([layout.shape] * (py * px), seed=py * 10 + px + halo_width)
    tiles = [views[iy * px:(iy + 1) * px] for iy in range(py)]
    ex = _check_exchange(lambda: HaloExchange(tiles, layout), pool)
    assert [ph.number for ph in ex.phases] == [0, 1]


@pytest.mark.parametrize("py", [1, 2, 4, 8])
def test_ghost_table_equals_copy_list(py):
    """Every slab's ghost rows from its neighbours' f (one phase)."""
    layout = SlabLayout(16 // py if py < 8 else 2, 24, 2)
    pool, views = _pool([layout.shape, layout.ghost_shape] * py, seed=py)
    slabs = [(views[2 * i], views[2 * i + 1]) for i in range(py)]
    ex = _check_exchange(lambda: GhostExchange(slabs, layout), pool)
    assert len(ex.phases) == 1


def test_table_rows_layout():
    """A row: the source's address and strides (floats), the
    destination's, then planes, rows, columns and a pad word."""
    a = torch.zeros(9, 6, 40)
    dst, src = a[:, 0:2, 4:36], a[:, 3:5, 4:36]
    (row,) = copy_rows([(dst, src)])
    assert row == [src.data_ptr(), 240, 40, 1, dst.data_ptr(), 240, 40, 1, 9, 2, 32, 0]


def test_overlap_is_refused():
    """A destination that overlaps a source of its phase, or another
    destination, cannot be copied at once: the table is refused."""
    a = torch.zeros(9, 8, 40)
    with pytest.raises(ValueError, match="overlaps a source"):
        copy_rows([(a[:, 0:2, :], a[:, 1:3, :])])
    with pytest.raises(ValueError, match="overlaps a source"):  # another piece's source
        copy_rows([(a[:, 0:1, :], a[:, 4:5, :]), (a[:, 6:7, 0:1], a[:, 0:1, 5:6])])
    with pytest.raises(ValueError, match="write the same element"):
        copy_rows([(a[:, 0:2, :], a[:, 4:6, :]), (a[:, 1:2, 3:9], a[:, 6:7, 3:9])])
    with pytest.raises(ValueError, match="write the same element"):  # strided columns
        copy_rows([(a[:, :, 0:2], a[:, :, 10:12]), (a[:, :, 1:3], a[:, :, 20:22])])
    # Interleaved rows of one buffer that share no element pass.
    check_disjoint([(a[:, :, 0:2], a[:, :, 2:4]), (a[:, :, 38:40], a[:, :, 36:38])])
    with pytest.raises(ValueError, match="3-D float32"):
        copy_rows([(a[:, 0:2, :], a[:, 3:6, :])])


def test_cpu_exchange_launches_nothing():
    """On CPU shards the phases have no device table and run their copy
    list: no kernel launch is counted."""
    layout = TileLayout(4, 8, 1)
    _, views = _pool([layout.shape] * 4, seed=1)
    ex = HaloExchange([views[:2], views[2:]], layout)
    launches = dict(fused.LAUNCHES)
    ex()
    assert fused.LAUNCHES == launches
    assert all(ph.table is None for ph in ex.phases)


def test_path_is_chosen_by_phase():
    """A phase over several devices is marked for peer copies and runs
    its copy list; copies on one device that is not the CPU, with no table
    and no such mark, raise instead of running the copy list."""
    layout = TileLayout(4, 8, 1)
    _, views = _pool([layout.shape] * 2, seed=2)
    ex = HaloExchange([views], layout)
    assert not any(ph.peer for ph in ex.phases)
    a, b = torch.rand(9, 2, 8), torch.zeros(9, 2, 8)
    halo.exchange_copy(halo._Phase([(b, a)], [], [], peer=True))
    assert torch.equal(a, b)
    meta = torch.empty(9, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="without a lbm_exchange_copy table"):
        halo.exchange_copy(halo._Phase([(meta, meta[:, :1].expand(9, 2, 8))], [], [], 3))


def test_kernel_equals_copy_list_on_card():
    """The kernel bitwise its copy list on a 2x2 mesh's two phases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: lbm_exchange_copy has no CPU mode")
    dev = torch.device("cuda", 0)
    layout = TileLayout(16, 32, 2)
    tiles = [[torch.rand(layout.shape, device=dev) for _ in range(2)] for _ in range(2)]
    ex = HaloExchange(tiles, layout)
    for ph in ex.phases:
        assert ph.table is not None
        halo.copy_plain(ph)
        want = [d.clone() for d, _ in ph.copies]
        for d, _ in ph.copies:
            d.fill_(float("nan"))
        halo.exchange_copy(ph)
        assert all(_same_bits(d, w) for (d, _), w in zip(ph.copies, want))
