"""Port parity of the evaluation tooling: utils/profiling (trace,
Throughput, checkify_nan), core/components' NerfDataset,
evaluation/visualization's pose plots (and their fallback without
matplotlib or PIL), evaluation/mesh.extract_mesh, and cli/evaluate against
the JAX package's cli/evaluate on one checkpoint trained by the JAX CLI
(quant_pose.txt, quant.txt, loss.txt, the transforms), with the JAX run's
test-time pixel draws."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.evaluation import mesh as jmesh
from myc_nerfs_tpu.evaluation import visualization as jvis
from myc_nerfs_tpu_torch.evaluation import mesh as tmesh
from myc_nerfs_tpu_torch.evaluation import visualization as tvis
from myc_nerfs_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- utils/profiling -----------------------------------------------------------

def test_throughput_and_trace(tmp_path):
    """Throughput counts items between two host reads (the JAX suite's
    case); trace writes a Chrome trace of the block."""
    t = profiling.Throughput()
    x = torch.ones(8)
    t.start(x)
    t.add(100)
    assert t.stop(x * 2) > 0
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_checkify_nan_raises():
    """checkify_nan passes finite outputs through (nested too) and raises on
    a NaN or an inf, as the JAX wrapper does on log(-1)."""
    f = profiling.checkify_nan(torch.log)
    assert float(f(torch.tensor(2.0))) == pytest.approx(np.log(2.0))
    with pytest.raises(FloatingPointError):
        f(torch.tensor(-1.0))
    g = profiling.checkify_nan(lambda x: {"a": (x, torch.arange(3)), "b": 1.0 / x})
    g(torch.tensor(1.0))
    with pytest.raises(FloatingPointError):
        g(torch.tensor(0.0))


# --- core/components: NerfDataset ----------------------------------------------

def _blender_dir(root, n=3, H=4, W=5, images=True):
    from myc_nerfs_tpu.data.synthetic import orbit_poses
    from myc_nerfs_tpu.evaluation.pose_export import write_transforms_json

    os.makedirs(root / "train", exist_ok=True)
    poses = orbit_poses(n)
    for split in ("train", "test"):
        write_transforms_json(str(root / f"transforms_{split}.json"), poses)
    if images:
        from PIL import Image

        rng = np.random.default_rng(0)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (H, W, 4), dtype=np.uint8)).save(
                root / "train" / f"r_{i}.png")
    return root


@pytest.mark.parametrize("mode", ["train", "test"])
def test_nerf_dataset_matches_jax(tmp_path, mode):
    """DATASETS' NerfDataset, the factory the configs name, builds the same
    NGP dataset as the JAX one: train mode from images, test mode from the
    poses alone (c2w_ngp, focal and images; rtol 1e-6)."""
    from myc_nerfs_tpu.core import components as jcomp  # noqa: F401 (registers)
    from myc_nerfs_tpu.core.registry import DATASETS as JD
    from myc_nerfs_tpu_torch.core import components as tcomp  # noqa: F401
    from myc_nerfs_tpu_torch.core.registry import DATASETS as TD

    root = str(_blender_dir(tmp_path))
    kw = dict(root_dir=root, mode=mode, aabb_scale=2, correct_pose=[-1, -1, 1])
    out, ref = TD.get("NerfDataset")(**kw), JD.get("NerfDataset")(**kw)
    np.testing.assert_allclose(np.asarray(out.c2w_ngp), np.asarray(ref.c2w_ngp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.focal), np.asarray(ref.focal), rtol=1e-6)
    assert np.asarray(out.images).shape == np.asarray(ref.images).shape
    np.testing.assert_allclose(np.asarray(out.images), np.asarray(ref.images), rtol=1e-6)


# --- evaluation/visualization --------------------------------------------------

def _orbit(n=6):
    from myc_nerfs_tpu.data.synthetic import orbit_poses

    return np.asarray(orbit_poses(n))


def test_frustum_points_match_jax():
    """A camera's wireframe vertices (centre and four corners) equal the
    JAX function's (rtol 1e-6, atol 1e-7)."""
    for p in _orbit():
        np.testing.assert_allclose(tvis._frustum_points(p, 0.3), jvis._frustum_points(p, 0.3),
                                   rtol=1e-6, atol=1e-7)


def test_pose_plot_and_video(tmp_path):
    """plot_poses writes an image (as the JAX suite's case), _imread reads
    it back, and save_pose_evolution_video makes one frame per entry and a
    video (or its frames where no encoder is installed)."""
    poses = _orbit()
    path = tvis.plot_poses(poses, poses, str(tmp_path / "p.png"))
    assert os.path.getsize(path) > 0
    img = tvis._imread(path)
    assert img.dtype == np.uint8 and img.shape[-1] == 3
    out = tvis.save_pose_evolution_video([poses, poses * 1.01], poses, str(tmp_path / "ev"),
                                         fps=2)
    assert os.path.exists(tmp_path / "ev" / "0001.png")
    assert out is None or os.path.getsize(out) > 0


def test_pose_plot_fallbacks(tmp_path, monkeypatch):
    """Without matplotlib, plot_poses writes the wireframes [sets, N, 5, 3]
    as .npy and returns None, and the evolution video is skipped; without
    PIL, _imread returns None. Each says so."""
    poses = _orbit(4)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tvis.plot_poses(poses, poses, str(tmp_path / "p.png")) is None
    arr = np.load(tmp_path / "p.npy")
    assert arr.shape == (2, 4, 5, 3)
    np.testing.assert_allclose(arr[0, 1], jvis._frustum_points(poses[1]), rtol=1e-6, atol=1e-7)
    assert tvis.save_pose_evolution_video([poses], poses, str(tmp_path / "ev")) is None
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tvis._imread(str(tmp_path / "p.npy")) is None


# --- evaluation/mesh.extract_mesh ------------------------------------------------

def test_extract_mesh_matches_jax():
    """extract_mesh of a sphere density (radius 0.73, off the lattice, in
    [-1.2, 1.2]^3 at res 24, threshold 25) against the JAX function: the
    same vertices as a set (atol 1e-5) and as many triangles (its native
    extractor numbers them in another order); against the JAX numpy
    extractor, which the port copies, on the JAX density grid: the same
    vertices in order (atol 1e-5) and the same triangles. Vertices lie on
    the sphere within a cell."""
    from myc_nerfs_tpu.ops.native import marching_tets_numpy

    def jfn(p):
        return 50.0 * (0.73 - jnp.linalg.norm(p, axis=-1)) + 25.0

    def tfn(p):
        return 50.0 * (0.73 - torch.linalg.norm(p, dim=-1)) + 25.0

    v, t = tmesh.extract_mesh(tfn, res=24, chunk=4096)
    vj, tj = (np.asarray(a) for a in jmesh.extract_mesh(jfn, res=24, chunk=4096))
    assert len(t) > 100 and v.shape == vj.shape and t.shape == tj.shape
    np.testing.assert_allclose(np.sort(v, axis=0), np.sort(vj, axis=0), rtol=0, atol=1e-5)
    vn, tn = marching_tets_numpy(jmesh.query_density_grid(jfn, 24, (-1.2, 1.2), 4096), 25.0)
    np.testing.assert_allclose(v, vn / 24 * 2.4 - 1.2, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t, tn)
    assert np.abs(np.linalg.norm(v, axis=-1) - 0.73).max() < 2.4 / 24


# --- cli/evaluate ----------------------------------------------------------------

EVAL_ARGS = ["--model=garf", f"--yaml={REPO}/configs/barf/Easyship.yaml", "--data.synthetic",
             "--data.textured", "--data.n_views=3", "--data.image_size=[12,12]",
             "--camera.noise=0.06", "--start_pose_correct_iter=0", "--nerf.rand_rays=96",
             "--nerf.sample_intvs=12"]
TT_ARGS = ["--optim.test_photo", "--optim.test_iter=1"]


def _jax_draws(n_views, rand_rays, n_pix, iters, seed=0):
    """cli/evaluate's test-time draws as the JAX CLI makes them: view i's
    key from split(key) per view, then split per iteration; randint."""
    key = jax.random.PRNGKey(seed)
    per_view = {}
    for i in range(n_views):
        key, k = jax.random.split(key)
        idx = []
        for _ in range(iters):
            k, kk = jax.random.split(k)
            idx.append(torch.from_numpy(np.array(jax.random.randint(kk, (rand_rays,), 0, n_pix))))
        per_view[i] = idx
    return lambda i: (lambda it: per_view[i][it])


def _rows(path):
    return [[float(v) for v in line.split()] for line in open(path)]


def _frames(path):
    return np.asarray([f["transform_matrix"] for f in json.load(open(path))["frames"]])


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A GARF run of the JAX train CLI (20 steps), evaluated by the JAX CLI
    and, on copies of its directory, by the port's: without (Easyship.yaml
    turns it on) and with test-time optimisation. Returns {tt: (jax dir, port dir)}."""
    import shutil

    from myc_nerfs_tpu.cli import evaluate as jeval
    from myc_nerfs_tpu.cli import train as jtrain
    from myc_nerfs_tpu_torch.cli import evaluate as teval

    root = tmp_path_factory.mktemp("evaluate")
    src = jtrain.main(EVAL_ARGS + [f"--output_root={root / 'train'}", "--max_iter_run=20"])
    rel = os.path.relpath(src, root / "train")
    dirs = {}
    for tt in (False, True):
        extra = TT_ARGS if tt else ["--optim.test_photo!"]
        pair = []
        for side in ("jax", "port"):
            base = root / f"{side}_{int(tt)}"
            shutil.copytree(src, base / rel)
            pair.append(str(base / rel))
        jeval.main(EVAL_ARGS + extra + [f"--output_root={root / f'jax_{int(tt)}'}"])
        teval.main(EVAL_ARGS + extra + [f"--output_root={root / f'port_{int(tt)}'}",
                                        "--device=cpu"],
                   tt_draws=_jax_draws(3, 96, 12 * 12, 100))
        dirs[tt] = tuple(pair)
    return dirs


def test_evaluate_outputs_match_jax(evaluated):
    """From the same checkpoint, without test-time optimisation:
    quant_pose.txt (rotation error in radians, translation error; atol
    1e-5), transform_train.json (atol 1e-5), quant.txt (PSNR within 1e-3
    dB), transform_val.json (the GT poses, atol 1e-5, ./val/r_{}), and
    each view's image as .npy (and .png)."""
    jdir, tdir = evaluated[False]
    a = np.asarray(_rows(os.path.join(tdir, "quant_pose.txt")))
    b = np.asarray(_rows(os.path.join(jdir, "quant_pose.txt")))
    assert a.shape == b.shape == (3, 3)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for name in ("transform_train.json", "transform_val.json"):
        np.testing.assert_allclose(_frames(os.path.join(tdir, name)),
                                   _frames(os.path.join(jdir, name)), atol=1e-5)
    assert [f["file_path"] for f in json.load(open(os.path.join(tdir, "transform_val.json")))[
        "frames"]] == ["./val/r_0", "./val/r_1", "./val/r_2"]
    np.testing.assert_allclose(np.asarray(_rows(os.path.join(tdir, "quant.txt"))),
                               np.asarray(_rows(os.path.join(jdir, "quant.txt"))), rtol=0,
                               atol=1e-3)
    assert not os.path.exists(os.path.join(tdir, "loss.txt"))
    for i in range(3):
        rgb = np.load(os.path.join(tdir, f"rgb_{i}.npy"))
        assert rgb.shape == (12, 12, 3) and np.isfinite(rgb).all()
        assert os.path.exists(os.path.join(tdir, f"rgb_{i}.png"))


def test_evaluate_test_time_run_matches_jax(evaluated):
    """With optim.test_photo (lr_pose / 2, stop 7e-4, test_iter 1 -> at most
    100 iterations) and the JAX run's draws: loss.txt has each view's
    iterations equal to the JAX CLI's and a finite best loss; the optimised
    val poses stay within 0.1 of the GT ones. The trajectories themselves
    part: see test_photometric_loss_matches_jax."""
    jdir, tdir = evaluated[True]
    a, b = _rows(os.path.join(tdir, "loss.txt")), _rows(os.path.join(jdir, "loss.txt"))
    assert len(a) == len(b) == 3
    assert [n for _, n in a] == [n for _, n in b]
    assert all(np.isfinite(loss) for loss, _ in a)
    gt = _frames(os.path.join(evaluated[False][1], "transform_val.json"))
    assert np.abs(_frames(os.path.join(tdir, "transform_val.json")) - gt).max() < 0.1


@pytest.mark.parametrize("se3", ["zero", "perturbed"])
def test_photometric_loss_matches_jax(evaluated, se3):
    """cli/evaluate's test-time loss and its d loss / d se3 against the JAX
    CLI's loss_fn on the same checkpoint, view and pixels, each measured
    against the port's loss in f64: the loss within 1e-4 relative in both
    packages, the gradient within 2e-2 of its largest component in both.
    GARF's gaussians (sigma 0.1) magnify f32 rounding: here both packages'
    f32 gradients sit 0.3-0.8% of the largest component off the f64 one
    (the port 0.151 and JAX 0.061 of 18.8 at se3 = 0), so 100 Adam steps
    in the two packages part."""
    import copy

    from myc_nerfs_tpu.cli import train as jtrain
    from myc_nerfs_tpu.core.checkpoint import restore_checkpoint as jrestore
    from myc_nerfs_tpu.geom import lie as jlie
    from myc_nerfs_tpu.geom import pose as jpose
    from myc_nerfs_tpu.geom import rays as jrays
    from myc_nerfs_tpu.render.mlp_renderer import render_rays_mlp as jrender
    from myc_nerfs_tpu.train import nerf_trainer as jnt
    from myc_nerfs_tpu_torch.cli import evaluate as teval
    from myc_nerfs_tpu_torch.cli import train as ttrain
    from myc_nerfs_tpu_torch.core.checkpoint import restore_checkpoint as trestore
    from myc_nerfs_tpu_torch.train import nerf_trainer as tnt

    jdir, tdir = evaluated[False]
    argv = EVAL_ARGS + ["--device=cpu"]
    cfg = ttrain.load_run_config(argv)
    images, poses, intr, H, W = ttrain.load_views(cfg)
    tcfg = ttrain.config_to_train_config(cfg)
    st, _ = trestore(os.path.join(tdir, "model.ckpt"),
                     tnt.init_state(tcfg, torch.Generator().manual_seed(0), 3, "cpu"))
    jcfg = ttrain.load_run_config(EVAL_ARGS)
    jimages, jposes, jintr, _, _ = jtrain.load_views(jcfg)
    jtc = jtrain.config_to_train_config(jcfg)
    model, jst = jnt.init_state(jtc, jax.random.PRNGKey(0), 3)
    jst, _ = jrestore(os.path.join(jdir, "model.ckpt"), jst)
    i = 1
    idx = _jax_draws(3, 96, H * W, 1)(i)(0)
    jidx = jnp.asarray(idx.numpy())

    def jloss(x):
        p = jpose.compose_pair(jlie.se3_to_SE3(x)[0], jposes[i])
        c, r = jrays.get_center_and_ray(p[None], jintr[i:i + 1], H, W,
                                        xy_grid=jrays.pixel_grid(H, W)[jidx])
        out = jrender(lambda pts, du: model.apply(jst.params, pts, du), c, r,
                      jax.random.PRNGKey(0), jtc.sample_intvs, jtc.depth_range,
                      stratified=False, view_dep=jtc.view_dep)
        return ((out.rgb[0] - jimages[i].reshape(-1, 3)[jidx]) ** 2).mean()

    x = (np.zeros((1, 6), np.float32) if se3 == "zero" else
         np.asarray([[0.01, -0.02, 0.015, 0.02, 0.01, -0.015]], np.float32))
    tl = teval.photometric_loss(tcfg, st.params, poses[i], intr[i], images[i], H, W)
    net64 = copy.deepcopy(st.params).double()
    tl64 = teval.photometric_loss(tcfg, net64, poses[i].double(), intr[i].double(),
                                  images[i].double(), H, W)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tl(xt, idx)
    (g,) = torch.autograd.grad(loss, xt)
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    loss64 = tl64(x64, idx)
    (g64,) = torch.autograd.grad(loss64, x64)
    l0, g0 = jax.value_and_grad(jloss)(jnp.asarray(x))
    g64 = g64.numpy()
    scale = np.abs(g64).max()
    assert scale > 0
    for lv, gv in ((float(loss.detach()), g.double().numpy()), (float(l0), np.asarray(g0))):
        assert lv == pytest.approx(float(loss64.detach()), rel=1e-4)
        np.testing.assert_allclose(gv, g64, rtol=0, atol=2e-2 * scale)
    assert all(p.grad is None and p.requires_grad for p in st.params.parameters())


def test_evaluate_refuses_without_a_card(tmp_path):
    """The default device is cuda: without one the CLI exits with an error."""
    from myc_nerfs_tpu_torch.cli import evaluate as teval

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        teval.main(EVAL_ARGS + [f"--output_root={tmp_path}"])
