"""Port parity of the BARF-family entry points: the YAML reader (against
yaml.safe_load, with the yaml package hidden), the _parent_ merge and the
dot-path overrides, the YAML -> NeRFTrainConfig mapping and the views,
compare_pose in both methods (against the JAX package's output file), the
train CLI on the CPU (checkpoint, resume, pose export, a JAX restore of its
checkpoint, the refusal to run on a missing card) and the GARF budget
runner's events."""
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from myc_nerfs_tpu.cli import train as jtrain
from myc_nerfs_tpu.core import checkpoint as jck
from myc_nerfs_tpu.core import config as jconfig
from myc_nerfs_tpu.evaluation import pose_export as jexport
from myc_nerfs_tpu.geom import lie as jlie
from myc_nerfs_tpu.geom import pose as jpose
from myc_nerfs_tpu.train import nerf_trainer as jnt
from myc_nerfs_tpu_torch.cli import compare_pose as tcompare
from myc_nerfs_tpu_torch.cli import garf_budget as tbudget
from myc_nerfs_tpu_torch.cli import train as ttrain
from myc_nerfs_tpu_torch.core import config as tconfig
from myc_nerfs_tpu_torch.evaluation import pose_export as texport

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "barf", "*.yaml")))
DEMO = os.path.join(REPO, "configs", "barf", "demo_synthetic.yaml")


@pytest.fixture()
def no_yaml(monkeypatch):
    """The yaml package made unimportable, as on the card's machine."""
    monkeypatch.setitem(sys.modules, "yaml", None)


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_reader_matches_safe_load(path, no_yaml):
    """Every configs/barf/*.yaml: parse_yaml equals yaml.safe_load on the
    file (1.e-4 floats, nulls, flow lists, nested maps), and load_config
    equals the JAX load_config after the _parent_ merge."""
    text = open(path).read()
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    assert tconfig.parse_yaml(text) == EXPECTED_SAFE_LOAD[path]
    assert tconfig.load_config(path) == EXPECTED_CONFIG[path]


# computed while yaml is importable (the JAX package's loader needs it)
EXPECTED_SAFE_LOAD = {p: yaml.safe_load(open(p).read()) for p in YAMLS}
EXPECTED_CONFIG = {p: jconfig.load_config(p) for p in YAMLS}

SNIPPETS = [
    "a: 1.e-4\nb: 1e-4\nc: 1.0e5\nd: 1.0e+5\ne: -2\nf: +3\ng: .5\nh: 1_000\ni: 0\n",
    "a: yes\nb: No\nc: ~\nd:\ne: null\nf: True\ng: off\nh: .inf\ni: -.Inf\n",
    "k: 'x # not a comment' # a comment\nl: \"q\\\"t\\n\"\nm: 'it''s'\nn: a:b\no: http://x\n",
    "m: [1, [2, 3], 'a b', \"c\", ~, [null], a b]\nn: []\n",
    "n:\n- 1\n- [2, 3]\n- x\no:\n  - p\n  -   q\nr:\n  s:\n    t: 1\n  u: 2\n",
    "",
    "# only a comment\n\n",
    "'quoted key': 1\nkey with spaces: 2\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_yaml_reader_subset_matches_safe_load(text):
    """The forms of the subset beyond what the configs use, as PyYAML 1.1
    resolves them (bools like yes/off, 1e-4 without a dot as a string)."""
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: 0x1f\n", "a: 010\n", "a: 1:30\n", "a: &x 1\n",
                                  "a: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: [1, 2\n",
                                  "a:\n\tb: 1\n", "a: 1\na: 2\n", "a: 1\n  b: 2\n",
                                  "a: {x: 1}\n", "a:\n- b: 1\n", "a:\n-\n  - 1\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    """Numbers in other bases, anchors, aliases, tags, block scalars, an open
    flow list, tab indentation, a duplicate key, bad indentation, flow maps
    and lists of maps or lists raise ValueError instead of reading as
    something else."""
    with pytest.raises(ValueError):
        tconfig.parse_yaml(text)


OVERRIDES = [
    ["--optim.lr=1e-3", "--nerf.rand_rays=512", "--camera.noise=0.15"],
    ["--nerf.fine_sampling", "--nerf.view_dep!", "--max_iter=5000", "--name=run 2"],
    ["--data.root=/tmp/x", "--arch.skip=[3]", "--freq.val=None"],
]


@pytest.mark.parametrize("args", OVERRIDES)
def test_apply_overrides_matches_jax(args):
    """Dot paths, bare --flag (True), --flag! (False) and literal values on
    the Easyship config, strict; and a new key raises in strict mode and is
    added otherwise, as in JAX."""
    base = jconfig.load_config(os.path.join(REPO, "configs/barf/Easyship.yaml"))
    assert tconfig.apply_overrides(base, args) == jconfig.apply_overrides(base, args)
    for a in ("--nope=1", "--arch.nope.deeper=2"):
        with pytest.raises(KeyError):
            tconfig.apply_overrides(base, [a])
        assert (tconfig.apply_overrides(base, [a], strict=False)
                == jconfig.apply_overrides(base, [a], strict=False))
    with pytest.raises(ValueError):
        tconfig.apply_overrides(base, ["optim.lr=1"])
    for s in ("1.e-4", "[1, 2]", "None", "abc", "True", "'x'"):
        assert tconfig.parse_value(s) == jconfig.parse_value(s)


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
@pytest.mark.parametrize("model", ["nerf", "barf", "garf"])
def test_config_to_train_config_matches_jax(path, model):
    """Every field of the NeRFTrainConfig the YAML maps to, for each model
    family, equal to JAX's (which also has mlp_tile, a TPU workaround)."""
    cfg = dict(jconfig.load_config(path), model=model)
    ref = jtrain.config_to_train_config(jconfig.Config.wrap(cfg))
    out = ttrain.config_to_train_config(tconfig.Config.wrap(cfg))
    fields = {f: getattr(ref, f) for f in ref.__dataclass_fields__ if f != "mlp_tile"}
    assert {f: getattr(out, f) for f in out.__dataclass_fields__} == fields


def test_load_views_matches_jax():
    """The synthetic views of demo_synthetic.yaml: images (atol 1e-3, the
    ground-truth render in two libraries), poses and intrinsics (1e-6)."""
    cfg = jconfig.load_config(DEMO)
    cfg["data"]["n_views"] = 3
    ref = jtrain.load_views(cfg)
    out = ttrain.load_views(tconfig.Config.wrap(dict(cfg)))
    assert out[3:] == ref[3:]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-3)
    for a, b in zip(out[1:3], ref[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _write_frames(path, c2ws, angle=0.9):
    frames = [{"file_path": f"./val/r_{i}", "transform_matrix": m.tolist(), "extra": i}
              for i, m in enumerate(c2ws)]
    with open(path, "w") as f:
        json.dump({"camera_angle_x": angle, "frames": frames, "note": "kept"}, f)


@pytest.mark.parametrize("method", ["trans", "sim3"])
def test_compare_pose_matches_jax(method, tmp_path):
    """compare_pose through the port's CLI against the JAX compare_pose on
    the same JSONs (refined val poses = a rigid delta and per-frame noise):
    the same keys and frame fields, transform matrices within 1e-5, and the
    file formatted alike (sort_keys, indent 4)."""
    rng = np.random.default_rng(0)
    w2c = np.asarray(jlie.se3_to_SE3(jnp.asarray(rng.standard_normal((7, 6)) * 0.7)))
    c2w = np.asarray(jpose.invert_pose(jnp.asarray(w2c)))
    bottom = np.broadcast_to([[[0, 0, 0, 1.0]]], (7, 1, 4))
    old = np.concatenate([c2w, bottom], 1)
    delta = np.asarray(jlie.se3_to_SE3(jnp.asarray(rng.standard_normal((7, 6)) * 0.02
                                                   + [0.05, -0.02, 0.04, 0.1, 0.2, -0.1])))
    new = np.einsum("nij,njk->nik", np.concatenate([delta, bottom], 1), old)
    p = {k: str(tmp_path / f"{k}.json") for k in ("vo", "vn", "to")}
    _write_frames(p["vo"], old[:5])
    _write_frames(p["vn"], new[:5])
    _write_frames(p["to"], old[5:])
    ref_path, out_path = str(tmp_path / "ref.json"), str(tmp_path / "out" / "test.json")
    jexport.compare_pose(p["vo"], p["vn"], p["to"], ref_path, method=method)
    assert tcompare.main(["--method", method, "--val_old", p["vo"], "--val_new", p["vn"],
                          "--test_old", p["to"], "--test_new", out_path]) == out_path
    ref, out = json.load(open(ref_path)), json.load(open(out_path))
    assert sorted(out) == sorted(ref) and out["note"] == "kept"
    for a, b in zip(out["frames"], ref["frames"]):
        assert {k: v for k, v in a.items() if k != "transform_matrix"} == \
            {k: v for k, v in b.items() if k != "transform_matrix"}
        np.testing.assert_allclose(a["transform_matrix"], b["transform_matrix"], atol=1e-5)
    assert open(out_path).read().splitlines()[:3] == open(ref_path).read().splitlines()[:3]


def test_write_and_load_transforms_match_jax(tmp_path):
    """write_transforms_json of world->cam poses and load_transforms_json:
    the same frames as the JAX package's file (1e-6) and the same text
    layout."""
    w2c = np.asarray(jlie.se3_to_SE3(jnp.asarray(
        np.random.default_rng(1).standard_normal((3, 6)) * 0.5)))
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    texport.write_transforms_json(a, torch.from_numpy(w2c.copy()))
    jexport.write_transforms_json(b, jnp.asarray(w2c))
    ma, angle_a, raw_a = texport.load_transforms_json(a)
    mb, angle_b, raw_b = jexport.load_transforms_json(b)
    np.testing.assert_allclose(ma.numpy(), np.asarray(mb), atol=1e-6)
    assert angle_a == angle_b and [f["file_path"] for f in raw_a["frames"]] == \
        [f["file_path"] for f in raw_b["frames"]]
    assert len(open(a).read().splitlines()) == len(open(b).read().splitlines())


def test_train_cli_on_cpu(tmp_path, monkeypatch):
    """cli.train on demo_synthetic.yaml as barf (pose noise, c2f) with
    --device=cpu: the train PSNR file, the checkpoint and its snapshot, the
    JAX restore_checkpoint of it, resume to a later step, and
    transform_train.json with one frame per view."""
    monkeypatch.chdir(tmp_path)
    args = [f"--yaml={DEMO}", "--model=barf", "--device=cpu", "--camera.noise=0.1",
            "--barf_c2f=[0.1,0.5]", "--data.n_views=4", "--max_iter_run=6",
            "--freq.scalar=2", "--freq.ckpt=3", "--freq.val=5"]
    out = ttrain.main(args)
    assert out == os.path.join("output", "demo", "synthetic")
    for f in ("model.ckpt", "model/3.ckpt", "model/6.ckpt", "train_psnr.txt",
              "train_error_R.txt", "val_psnr.txt", "transform_train.json"):
        assert os.path.exists(os.path.join(out, f)), f
    assert json.load(open(os.path.join(out, "model.ckpt.json")))["step"] == 6
    assert len(open(os.path.join(out, "train_psnr.txt")).read().splitlines()) == 3
    frames = json.load(open(os.path.join(out, "transform_train.json")))["frames"]
    assert len(frames) == 4 and len(frames[0]["transform_matrix"]) == 4
    jcfg = jtrain.config_to_train_config(jconfig.apply_overrides(
        jconfig.load_config(DEMO), args[1:], strict=False))
    _, jstate = jnt.init_state(jcfg, jax.random.PRNGKey(3), 4)
    restored, meta = jck.restore_checkpoint(os.path.join(out, "model.ckpt"), jstate)
    assert int(restored.step) == 6 and meta["step"] == 6
    assert np.abs(np.asarray(restored.se3_refine)).max() > 0
    out2 = ttrain.main(args[:-4] + ["--max_iter_run=8", "--resume", "--freq.scalar=100",
                                    "--freq.ckpt=100", "--freq.val=100"])
    assert json.load(open(os.path.join(out2, "model.ckpt.json")))["step"] == 8


def test_train_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    """Without --device=cpu the CLI runs on CUDA or exits with an error."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="device=cpu"):
        ttrain.main([f"--yaml={DEMO}", "--max_iter_run=1"])
    with pytest.raises(SystemExit, match="device cpu"):
        tbudget.main(["--steps", "16"])


def test_garf_budget_events_on_cpu(capsys):
    """The GARF budget runner at a tiny size: start, log and done events with
    the JAX script's keys, the ratios of final to initial error, and the gate
    at gate_frac of the steps."""
    tbudget.main(["--device", "cpu", "--steps", "48", "--views", "3", "--size", "8",
                  "--rand_rays", "24", "--samples", "8", "--log_every", "16"])
    events = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds == ["garf_budget_start", "garf_budget_log", "garf_budget_log",
                     "garf_budget_done"]
    start, done = events[0], events[-1]
    assert start["start_pose_correct"] == 19 and start["device"] == "cpu"
    assert start["rot_err_deg_init"] > 0 and done["steps"] == 48
    assert done["rot_ratio"] == pytest.approx(done["rot_err_deg_final"]
                                              / done["rot_err_deg_init"], rel=1e-2)
    for key in ("train_psnr", "rot_err_deg", "rot_err_med", "rot_err_max", "trans_err",
                "it_s"):
        assert np.isfinite(events[1][key])
