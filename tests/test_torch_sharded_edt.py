"""The port's row-block sharded EDT against the plain ``edt_clamped`` and
``lidar_slam_tpu.parallel.sharded_edt`` on the 8-device virtual mesh (the
counterpart of ``tests/test_sharded_edt.py``). D = 1..8 blocks run in one
process through ``edt_row_block``; a gloo world of one runs the exchange
itself; the blocks' K1 launches are held to the plain version on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_util  # noqa: F401  (caps torch's threads)
from lidar_slam_tpu.parallel import sharded_edt as jsedt
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel import multihost, sharded_edt

CASES = [(128, 0.05, 1), (160, 0.02, 0), (240, 0.008, 2)]


@pytest.fixture(scope="module")
def axis():
    """A "map" axis over a gloo world of one, made and destroyed here."""
    assert multihost.initialize(device_type="cpu") == (0, 1)
    yield mesh_lib.make_axis("map", "cpu")
    multihost.shutdown()


@pytest.fixture(scope="module")
def jax_map_mesh():
    return Mesh(np.asarray(jax.devices()).reshape(8), axis_names=("map",))


def _occ(size, density, seed):
    return np.random.default_rng(seed).random((size, size)) < density


@pytest.mark.parametrize("size,density,seed", CASES)
def test_row_blocks_equal_plain_and_jax(jax_map_mesh, size, density, seed):
    """Every D = 1..8 that splits the grid into blocks of >= 10 rows:
    ``torch.equal`` to ``edt_clamped``; within 1e-5 (the JAX test's
    tolerance) of JAX's halo-exchange transform on 8 devices."""
    occ = _occ(size, density, seed)
    want = edt_ops.edt_clamped(torch.as_tensor(occ))
    n_blocks = [d for d in range(1, 9) if size % d == 0]
    assert 8 in n_blocks
    for d in n_blocks:
        assert torch.equal(sharded_edt.edt_blocks(torch.as_tensor(occ), d),
                           want), d
    jgot = np.asarray(jsedt.edt_sharded(jnp.asarray(occ), jax_map_mesh))
    np.testing.assert_allclose(want.numpy(), jgot, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size,density,seed", CASES)
def test_world_of_one_exchange_equals_plain(axis, size, density, seed):
    occ = torch.as_tensor(_occ(size, density, seed))
    want = edt_ops.edt_clamped(occ)
    assert torch.equal(sharded_edt.edt_sharded(occ, axis), want)
    assert torch.equal(sharded_edt.edt_replicated(occ, axis), want)
    assert axis.calls >= 2


def test_extended_blocks_carry_their_neighbours_rows():
    occ = torch.as_tensor(_occ(40, 0.2, 3))
    ext = sharded_edt.extended_blocks(occ, 2, 10)
    assert ext.shape == (2, 40, 40)
    assert not ext[0, :10].any() and not ext[1, 30:].any()
    assert torch.equal(ext[0, 10:40], occ[:30])
    assert torch.equal(ext[1, :30], occ[10:])


def test_cross_block_distances():
    """One obstacle in the last row of block 0 of 8: distances cross into
    block 1 (the JAX test's points)."""
    occ = torch.zeros((128, 128), dtype=torch.bool)
    occ[15, 64] = True
    got = sharded_edt.edt_blocks(occ, 8)
    assert got[15, 64] == 0.0
    assert got[16, 64] == pytest.approx(1.0)
    assert got[21, 72] == pytest.approx(10.0)
    assert got[23, 64] == pytest.approx(8.0)
    assert got[8, 64] == pytest.approx(7.0)
    assert torch.equal(got, edt_ops.edt_clamped(occ))


def test_thin_blocks_rejected(axis):
    with pytest.raises(ValueError, match="shard height"):
        sharded_edt.edt_blocks(torch.zeros((64, 64), dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="shard height"):
        sharded_edt.edt_sharded(torch.zeros((8, 64), dtype=torch.bool), axis)
    with pytest.raises(ValueError, match="equal blocks"):
        sharded_edt.edt_blocks(torch.zeros((100, 64), dtype=torch.bool), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("size,n", [(512, 2), (512, 4), (512, 8), (400, 2),
                                    (400, 4), (400, 8)])
def test_row_blocks_on_k1_equal_plain(size, n):
    """K1 on every extended block (the sharded PF's building and museum
    fine rasters cut in 2, 4 and 8): each block ``torch.equal`` to the
    plain version, and the whole to K1 on the whole grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lidar_slam_tpu_torch.ops import cuda_edt

    occ = torch.as_tensor(_occ(size, 0.01, n), device="cuda")
    for block in sharded_edt.extended_blocks(occ, n):
        got = sharded_edt.edt_row_block(block)
        assert torch.equal(got, sharded_edt.edt_row_block(block.cpu()).cuda())
    whole = cuda_edt.edt_clamped_cuda(occ)
    assert torch.equal(sharded_edt.edt_blocks(occ, n), whole)
    torch.cuda.synchronize()
