"""The port's ``parallel/`` engines on the CPU, against the port's
unsharded engines and the JAX package's, on the same numpy-seeded inputs.

Every rank is a process spawned by ``parallel.launcher.run_local`` over
gloo (a ``file://`` rendezvous, so parallel test workers never contend for
a port), running the port's ``parallel/programs.py`` tasks; each world is
joined under JOIN_TIMEOUT, after which its ranks are killed by PID and the
test fails.  Three worlds (2, 3 and 4 ranks, one after another), each
shared by a module-scoped fixture, run everything here; the ranks never
import JAX (each reports whether it did).

* ``overlap_blocks`` against the JAX package's, 3 blocks of 61 rows among
  them;
* ``local_topk``/``merge_topk`` against JAX ``merge_topk`` in a
  ``jax.shard_map`` over 2 of the conftest's 8 CPU devices;
* the launcher's single-process no-op and its grid axes (the rules of the
  JAX package's tests/test_parallel.py TestLauncher);
* the row-sharded pair (``tests/synth.py converging_rig``, 64x80, 2 and 3
  row ranks, float64): bit-equal to the port's unsharded maps and to JAX
  ``twoview_pairs_rowsharded(method="fast", dtype=float64)`` on a 1x2 mesh;
* 2 pairs on a 2x2 grid: bit-equal per pair to the unsharded port;
* the depth-sharded MVS (2 ranks, WTA and top-K, float64): bit-equal to the
  port's unsharded estimate, and against JAX
  ``mvs_initial_estimate_oneview(method="exact")`` (the JAX package's
  depth-sharded engine has no exact backend; its tests/test_depthshard.py
  holds its sharded result equal to its unsharded one): the same sentinel
  classes everywhere and depths and NCCs within 1e-12 relative — XLA
  contracts the uniform labels' ``a*b + c`` into an FMA, so a label
  differs from the port's in its last bit;
* ``schur_blocks_allreduce`` over 2 ranks against JAX ``schur_blocks`` on
  the whole observation set (1e-12 relative);
* ``cli stereo --shard row`` / ``--shard depth`` over 2 ranks with
  ``--device cpu --save-npz``: the unsharded port CLI's depths, rank 1
  silent and writing nothing, and the JAX CLI's stderr note for each
  ``--shard`` that does not apply;
* ``scaling.row_blocks`` against the blocks the row ranks swept.

On one worker the file takes ~65 s on an 8-core CPU (``--durations``:
after the JAX references, ~13 s more waiting for the 2-rank world and
~21 s for the 4-rank one; the JAX ``schur_blocks`` compile ~8 s, the
renders ~8 s, the JAX row-sharded ``shard_map`` ~4 s)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from stereoreconstruction_tpu.calib.bundle import schur_blocks as jschur
from stereoreconstruction_tpu.config import MultiViewConfig as JMConfig
from stereoreconstruction_tpu.config import TwoViewConfig as JTConfig
from stereoreconstruction_tpu.parallel import collectives as jcoll
from stereoreconstruction_tpu.parallel import rowshard as jrow
from stereoreconstruction_tpu.stereo import multiview as jmv
from stereoreconstruction_tpu_torch import cli
from stereoreconstruction_tpu_torch.config import MultiViewConfig as TMConfig
from stereoreconstruction_tpu_torch.config import TwoViewConfig as TTConfig
from stereoreconstruction_tpu_torch.geometry.camera import stack_cameras
from stereoreconstruction_tpu_torch.parallel import (collectives, launcher,
                                                     programs, rowshard,
                                                     scaling)
from stereoreconstruction_tpu_torch.stereo import multiview as tmv
from stereoreconstruction_tpu_torch.stereo.twoview import compute_depth_maps

from synth import converging_rig, render_scene
from test_torch_cli import ARGS, project  # noqa: F401 (fixture)
from test_torch_mvs import port_cameras

torch.set_num_threads(1)

JOIN_TIMEOUT = 240.0      # seconds a spawned world may take in all
F64 = torch.float64
TWO_KW = dict(window_radius=2, min_depth=45.0, max_depth=80.0,
              num_depth_levels=12, image_scale=1.0)
MVS_KW = dict(window_radius=2, min_depth=45.0, max_depth=80.0,
              num_depth_levels=24, image_scale=1.0)


def world(n, tasks):
    """Each rank's task results of a spawned gloo world of ``n`` ranks;
    no rank may have imported JAX."""
    res = launcher.run_local(programs.run_tasks, (tasks,), world_size=n,
                             backend="gloo", threads=1,
                             timeout=JOIN_TIMEOUT)
    for rank in res:
        for rep in rank:
            if isinstance(rep, dict) and "jax_loaded" in rep:
                assert not rep["jax_loaded"]
    return res


def bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=True))


# --------------------------------------------------------------------------
# inputs (numpy, seeded) and the unsharded references
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """Two pairs of the converging rig at 64x80 (different planes), float32
    images with mask holes."""
    cams = converging_rig(2)
    out = []
    for pd, seed in ((58.0, 0), (66.0, 1)):
        rgbs, masks, _ = render_scene(cams, 64, 80, plane_dist=pd,
                                      seed=seed, enable_refraction=False)
        masks[0, 10:14, 20:30] = False
        masks[1, 40:44, 5:15] = False
        out.append((rgbs.astype(np.float32), masks))
    rgbs = np.stack([p[0] for p in out])              # [pair, 2, H, W, 3]
    masks = np.stack([p[1] for p in out])
    tc = port_cameras(cams)
    args = dict(rgbs_l=rgbs[:, 0], masks_l=masks[:, 0], rgbs_r=rgbs[:, 1],
                masks_r=masks[:, 1], cams_l=stack_cameras([tc[0]] * 2),
                cams_r=stack_cameras([tc[1]] * 2), cfg=TTConfig(**TWO_KW),
                dtype=F64, device="cpu")
    want = [compute_depth_maps(r[0], m[0], r[1], m[1], tc[0], tc[1],
                               TTConfig(**TWO_KW), dtype=F64, device="cpu")
            for r, m in zip(rgbs, masks)]
    return dict(cams=cams, rgbs=rgbs, masks=masks, args=args,
                want=[(w.depth_left.numpy(), w.depth_right.numpy())
                      for w in want])


def first_pair(args):
    """The engine arguments of ``pairs`` cut to its first pair."""
    out = dict(args)
    for k in ("rgbs_l", "masks_l", "rgbs_r", "masks_r"):
        out[k] = args[k][:1]
    for k in ("cams_l", "cams_r"):
        out[k] = type(args[k])(*[f[:1] for f in args[k]])
    return out


@pytest.fixture(scope="module")
def mvs_scene():
    """Three views of the rig at 48x64 (tests/test_depthshard.py's scene),
    float32 images, float64 sweep."""
    cams = converging_rig(3)
    rgbs, masks, _ = render_scene(cams, 48, 64, plane_dist=60.0,
                                  enable_refraction=False)
    masks[0, 8:12, 20:28] = False
    return cams, rgbs.astype(np.float32), masks


@pytest.fixture(scope="module")
def ba_problem():
    """bench.py's bundle-adjustment size: 8 cameras, 512 points, 4,096
    observations (numpy seed 1)."""
    rng = np.random.default_rng(1)
    n_cams, n_pts, n_obs = 8, 512, 4096
    Ks = np.stack([np.array([[800.0, 0, 320], [0, 800.0, 240],
                             [0, 0, 1]])] * n_cams)
    return dict(poses=rng.normal(0, 0.03, (n_cams, 6)),
                points=rng.uniform([-80, -60, 350], [80, 60, 650],
                                   (n_pts, 3)), Ks=Ks,
                cam_idx=rng.integers(0, n_cams, n_obs),
                pt_idx=rng.integers(0, n_pts, n_obs),
                meas=rng.uniform([0, 0], [640, 480], (n_obs, 2)),
                n_cams=n_cams, n_pts=n_pts)


@pytest.fixture(scope="module")
def topk_lists():
    """Per-rank raw top-K lists of 2 ascending slabs with ties across
    and within them (ncc [2, K, 5, 6], depth ascending by slab)."""
    rng = np.random.default_rng(4)
    k = 4
    ncc = np.round(rng.uniform(0.9, 1.0, (2, k, 5, 6)), 2)
    ncc[:, 0] = -np.inf
    ncc = np.sort(ncc, axis=1)
    depth = np.stack([np.broadcast_to(
        (50.0 + 10 * s + np.arange(k))[:, None, None], (k, 5, 6))
        for s in range(2)]).copy()
    return ncc, depth, k


CLI_RUNS = {
    # name: (argv over 2 ranks, the unsharded run's argv, the stderr note
    # of the JAX CLI or None)
    "two_view_row": (["--two-view", "--shard", "row"], ["--two-view"],
                     None),
    "mvs_depth": (["--shard", "depth"], [], None),
    "two_view_depth": (["--two-view", "--shard", "depth"], ["--two-view"],
                       "--shard depth does not apply to --two-view; "
                       "running unsharded (use --shard row)"),
    "mvs_row": (["--shard", "row"], [],
                "--shard row does not apply to MVS; running unsharded "
                "(use --shard depth)"),
    "mrf_row": (["--two-view", "--mrf", "--shard", "row"],
                ["--two-view", "--mrf"],
                "--mrf runs unsharded (dense-label volume)"),
    # the slabs run the kernel method; the JAX CLI names its own fast path
    "exact_depth": (["--method", "exact", "--shard", "depth"], [],
                    "--shard depth has no 'exact' slab backend; running "
                    "the kernel method per slab"),
}


def cli_argv(project, name, sharded=True):
    """(argv, output directory) of a CLI run: over 2 ranks, or the
    unsharded run it is held to (``--shard none``)."""
    out = project / f"shard_{name}_{'sharded' if sharded else 'none'}"
    extra = (CLI_RUNS[name][0] if sharded
             else CLI_RUNS[name][1] + ["--shard", "none"])
    return ["stereo", str(project / "p.xml"), "-o", str(out), "--save-npz",
            str(out / "d.npz")] + ARGS + extra, out


@pytest.fixture(scope="module", autouse=True)
def worlds(pairs, mvs_scene, ba_problem, topk_lists, project):  # noqa: F811
    """The three spawned worlds, run one after another in a background
    thread from the module's start (the JAX references compute meanwhile;
    at most 4 ranks at a time); each ``world<n>`` fixture waits for its
    own.

    2 ranks: the row-sharded first pair, the depth-sharded MVS (WTA depths
    of every view, view 0's top-K), the Schur blocks, the top-K merge and
    the CLI runs.  3 ranks: the first pair over 3 row ranks (64 rows: two
    blocks of 22 rows and a ragged one of 20).  4 ranks: 2 pairs on a 2x2
    grid, and the grid axes."""
    cams, rgbs, masks = mvs_scene
    ncc, depth, k = topk_lists
    one = first_pair(pairs["args"])
    tasks = {
        2: [("twoview_rows", dict(n_view=1, n_row=2, **one)),
            ("mvs_slabs", dict(n_depth=2, rgbs=rgbs, masks=masks,
                               cams=port_cameras(cams),
                               cfg=TMConfig(**MVS_KW), topk_view=0,
                               dtype=F64, device="cpu")),
            ("schur", dict(device="cpu", **ba_problem)),
            ("topk_merge", dict(local_ncc=ncc, local_depth=depth, k=k))]
        + [("cli", dict(argv=cli_argv(project, n)[0])) for n in CLI_RUNS],
        3: [("twoview_rows", dict(n_view=1, n_row=3, **one))],
        4: [("twoview_pairs", dict(n_view=2, n_row=2, **pairs["args"])),
            ("grid_axes", dict(n_views_list=[2, 1]))]}
    with ThreadPoolExecutor(1) as ex:
        yield {n: ex.submit(world, n, t) for n, t in tasks.items()}


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2].result()


@pytest.fixture(scope="module")
def world3(worlds):
    return worlds[3].result()


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4].result()


# --------------------------------------------------------------------------
# host pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,n_blocks,halo", [(7, 2, 2), (61, 3, 6),
                                             (64, 3, 3), (5, 4, 1)])
def test_overlap_blocks_match_jax(h, n_blocks, halo):
    rng = np.random.default_rng(h)
    for x, fill in ((rng.normal(size=(h, 9)), 0.0),
                    (rng.normal(size=(h, 9, 3)), 0.0),
                    (rng.uniform(size=(h, 9)) > 0.5, False)):
        got = rowshard.overlap_blocks(x, n_blocks, halo, fill=fill)
        want = jrow.overlap_blocks(x, n_blocks, halo, fill=fill)
        assert got.dtype == want.dtype and bit_equal(got, want)
        tile = -(-h // n_blocks)
        assert got.shape[1] == tile + 2 * halo
        np.testing.assert_array_equal(
            rowshard._unblock(got[:, halo:halo + tile], h), x)
        np.testing.assert_array_equal(
            np.asarray(jrow._unblock(jnp.asarray(got[:, halo:halo + tile]),
                                     h)), x)


def test_local_topk_matches_jax(topk_lists):
    ncc, depth, k = topk_lists
    flat_n, flat_d = ncc.reshape(-1, 5, 6), depth.reshape(-1, 5, 6)
    got = collectives.local_topk(torch.as_tensor(flat_n),
                                 torch.as_tensor(flat_d), k)
    want = jcoll.local_topk(jnp.asarray(flat_n), jnp.asarray(flat_d), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_topk_matches_jax_shard_map(world2, topk_lists):
    ncc, depth, k = topk_lists
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("depth",))
    fn = jax.shard_map(lambda n, d: jcoll.merge_topk(n[0], d[0], k,
                                                     "depth"),
                       mesh=mesh, in_specs=(P("depth"), P("depth")),
                       out_specs=(P(), P()), check_vma=False)
    want = [np.asarray(x) for x in fn(jnp.asarray(ncc), jnp.asarray(depth))]
    # ties within and across slabs: the larger depth survives
    assert (np.diff(want[0], axis=0) == 0).any()
    for rank in world2:
        got = rank[3]
        np.testing.assert_array_equal(got["ncc"], want[0])
        np.testing.assert_array_equal(got["depth"], want[1])


def test_launcher_single_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launcher.initialize_distributed() is False
    assert launcher.is_coordinator() and launcher.world_size() == 1
    grid = launcher.global_mesh(n_views=2)
    assert grid.axis_names == ("view", "row")
    assert grid.ranks.shape == (1, 1) and grid.member
    assert grid.row_group is None and grid.view_group is None
    # a world of one without a process group: the collectives are the
    # identity
    t = torch.arange(6.0).reshape(2, 3)
    assert bit_equal(collectives.all_gather(t)[0], t)
    assert bit_equal(collectives.all_reduce_sum(t), t)


def test_grid_axes_of_a_world(world4):
    """test_parallel.py TestLauncher's rules over a world of 4: n_views=2
    gives 2 view rows, n_views=1 folds every rank into the row axis."""
    for rank in world4:
        (names2, g2), (names1, g1) = rank[1]
        assert names2 == names1 == ("view", "row")
        assert g2.size == g1.size == 4
        assert g2.shape[0] == 2 and g1.shape == (1, 4)
        assert bit_equal(g2.ravel(), np.arange(4))


def test_backend_rule():
    assert launcher.choose_backend("cpu", 1) == "gloo"
    n = torch.cuda.device_count()
    assert launcher.choose_backend("cuda", n + 1) == "gloo"
    assert launcher.choose_backend("cuda", max(n, 1)) == (
        "nccl" if n >= 1 else "gloo")


# --------------------------------------------------------------------------
# the sharded engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_row", [2, 3])
def test_rowsharded_pair_matches_unsharded(n_row, pairs, world2, world3):
    reps = [r[0] for r in (world2 if n_row == 2 else world3)]
    want = pairs["want"][0]
    for rep in reps:
        assert bit_equal(rep["left"][0], want[0])
        assert bit_equal(rep["right"][0], want[1])
    assert np.isinf(want[0]).any() and np.isfinite(want[0]).mean() > 0.3
    # each rank swept the blocks (left, right) that scaling.row_blocks
    # models
    blocks = scaling.row_blocks(64, n_row, TWO_KW["window_radius"] + 1)
    assert [rep["blocks"] for rep in reps] == [
        [(b["row0"], b["block_rows"])] * 2 for b in blocks]
    assert rowshard.overlap_blocks(np.zeros((64, 80)), n_row, 3).shape[1] \
        == blocks[0]["block_rows"]


def test_rowsharded_pair_matches_jax(pairs, world2):
    cams, rgbs, masks = pairs["cams"], pairs["rgbs"], pairs["masks"]
    dl, dr = jrow.twoview_pairs_rowsharded(
        jrow.make_mesh(1, 2), rgbs[:1, 0], masks[:1, 0], rgbs[:1, 1],
        masks[:1, 1], jrow.stack_cameras([cams[0]]),
        jrow.stack_cameras([cams[1]]), JTConfig(**TWO_KW), method="fast",
        dtype=jnp.float64, enable_refraction=False,
        enable_distortion=False)
    for rank in world2:
        assert bit_equal(rank[0]["left"], np.asarray(dl))
        assert bit_equal(rank[0]["right"], np.asarray(dr))


def test_batched_pairs_match_unsharded(pairs, world4):
    for rank in world4:
        got = rank[0]["depths"]
        assert got.shape == (2, 2, 64, 80)
        for p, want in enumerate(pairs["want"]):
            assert bit_equal(got[p], np.stack(want))


@pytest.fixture(scope="module")
def mvs_want(mvs_scene):
    """The port's unsharded MVS (depth maps, view 0's top-K) and JAX's
    exact view-0 estimate, float64."""
    cams, rgbs, masks = mvs_scene
    tc = port_cameras(cams)
    cfg = TMConfig(**MVS_KW)
    depths = tmv.mvs_depth_maps(rgbs, masks, tc, cfg, dtype=F64,
                                device="cpu").numpy()
    # the grays as mvs_depth_maps computes them, in float64
    rgb = torch.as_tensor(rgbs, dtype=F64)
    grays = (0.11 * rgb[..., 0] + 0.59 * rgb[..., 1]
             + 0.3 * rgb[..., 2]).numpy()
    nbr = tmv.select_neighbours(tc, cfg)[0]
    view0 = (rgbs[0], torch.as_tensor(grays[0]), masks[0], grays[nbr],
             masks[nbr])
    port = [tmv.mvs_initial_estimate_oneview(
        *view0, tc[0], stack_cameras([tc[j] for j in nbr]), cfg,
        enable_refraction=False, enable_distortion=False, with_topk=topk,
        device="cpu") for topk in (False, True)]
    c64 = [c.astype(jnp.float64) for c in cams]
    cams_nbr = jax.tree.map(lambda *xs: jnp.stack(xs), *[c64[j] for j in nbr])
    jargs = [jnp.asarray(x, jnp.float64) if x.dtype != bool
             else jnp.asarray(x) for x in (rgbs[0], grays[0], masks[0],
                                           grays[nbr], masks[nbr])]
    jax_exact = [jmv.mvs_initial_estimate_oneview(
        *jargs, c64[0], cams_nbr, JMConfig(**MVS_KW), len(nbr),
        enable_refraction=False, method="exact", with_topk=topk)
        for topk in (False, True)]
    return dict(depths=depths, wta0=port[0].numpy(),
                topk0=[t.numpy() for t in port[1]],
                jax_wta0=np.asarray(jax_exact[0]),
                jax_topk0=[np.asarray(t) for t in jax_exact[1]])


def test_depthsharded_mvs_matches_unsharded(world2, mvs_want):
    for rank in world2:
        rep = rank[1]
        assert bit_equal(rep["depths"], mvs_want["depths"])
        assert bit_equal(rep["topk"]["ncc"], mvs_want["topk0"][0])
        assert bit_equal(rep["topk"]["depth"], mvs_want["topk0"][1])
        # kernel 2's slab interface: each rank sweeps its own labels
        assert rep["mvs_sweep_label0"] == [12 * rep["rank"]] * 3
        assert rep["topk"]["mvs_sweep_label0"] == [12 * rep["rank"]]
    assert (mvs_want["depths"] > 0).mean() > 0.3


def test_depthsharded_mvs_matches_jax_exact(world2, mvs_want):
    def classes(d):
        return np.where(np.isinf(d), 0, np.where(d == -1.0, 1, 2))
    got = world2[0][1]["depths"][0]
    want = mvs_want["jax_wta0"]
    # view 0's estimate before the cross-check is the port's WTA map
    assert bit_equal(mvs_want["wta0"][np.isinf(got)], got[np.isinf(got)])
    np.testing.assert_array_equal(classes(mvs_want["wta0"]), classes(want))
    np.testing.assert_allclose(mvs_want["wta0"], want, rtol=1e-12, atol=0)
    tn, td = world2[0][1]["topk"]["ncc"], world2[0][1]["topk"]["depth"]
    jn, jd = mvs_want["jax_topk0"]
    np.testing.assert_array_equal(td < 0, jd < 0)
    np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-12)
    assert (jd > 0).sum() > 3 * jd[0].size


def test_schur_blocks_allreduce_match_jax(world2, ba_problem):
    b = ba_problem
    want = jschur(jnp.asarray(b["poses"]), jnp.asarray(b["points"]),
                  jnp.asarray(b["Ks"]), jnp.asarray(b["cam_idx"]),
                  jnp.asarray(b["pt_idx"]), jnp.asarray(b["meas"]),
                  b["n_cams"], b["n_pts"])
    for rank in world2:
        rep = rank[2]
        assert rep["n_obs"] == 2048
        for g, w in zip(rep["blocks"], want):
            w = np.asarray(w)
            assert g.dtype == np.float64 and g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()


# --------------------------------------------------------------------------
# the CLI over 2 ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_shard_over_two_ranks(name, world2, project):  # noqa: F811
    """Rank 0 writes the npz (the unsharded CLI's depths) with the JAX
    CLI's note, rank 1 prints nothing."""
    argv, out = cli_argv(project, name)
    (rc0, out0, err0), (rc1, out1, err1) = [r[4 + list(CLI_RUNS).index(name)]
                                           for r in world2]
    assert rc0 == 0 and rc1 == 0, (err0, err1)
    assert out1 == "" and err1 == ""
    note = CLI_RUNS[name][2]
    if note is None:
        assert ("row-sharded over 2 devices" if "--two-view" in argv
                else "depth-slab sharded over 2 devices") in err0
    else:
        assert note in err0
    ref_argv, ref_out = cli_argv(project, name, sharded=False)
    assert cli.main(ref_argv) == 0
    got, want = np.load(out / "d.npz"), np.load(ref_out / "d.npz")
    assert bit_equal(got["depths"], want["depths"])
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref_out))


def test_cli_shard_with_one_process(project, capsys):  # noqa: F811
    argv, _ = cli_argv(project, "two_view_row")
    argv[3] += "_single"
    assert cli.main(argv) == 0
    assert ("--shard row requested but only 1 device is visible; running "
            "unsharded") in capsys.readouterr().err
