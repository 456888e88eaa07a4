"""Quality parity of the port and the JAX package on one machine: both
train NGP (the quality harness's variants: brick3 with the fused march, or
the vertex hash with the bitfield march and network compaction; lr 1e-2,
n_coarse 128, n_compact 20) on the same small detail scene (36 views at
48^2, views 0, 12, 24 held out) from the same pixel draws, 1536 steps of
2048 rays, and render the held-out views. Their mean val PSNRs must agree
within the 0.2 dB gate noise (PERF_NOTES §16); the random streams of the
two packages differ, so quality is compared, not bits.

Slow: 5-55 minutes per package and case on a CPU (the port's hash case
is the longest). Run with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quality_parity.py
-m slow -s`` (each run prints one JSON line)."""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.data.synthetic import make_detail_scene
from myc_nerfs_tpu.geom import rays as jrays

SIZE, VIEWS, STEPS, BATCH, GRID = 48, 36, 1536, 2048, 1 << 14
GATE_NOISE_DB = 0.2


def _scene():
    """The scene (numpy) and the train rays in the NGP box."""
    scene = make_detail_scene(n_views=VIEWS, H=SIZE, W=SIZE, n_samples=256)
    val = [0, VIEWS // 3, 2 * VIEWS // 3]
    tr = jnp.asarray([i for i in range(VIEWS) if i not in val])
    c, r = jrays.get_center_and_ray(scene.poses[tr], scene.intr[tr], SIZE, SIZE)
    d = r / jnp.linalg.norm(r, axis=-1, keepdims=True)
    rays = (np.asarray((c * 0.33 + 0.5).reshape(-1, 3)), np.asarray(d.reshape(-1, 3)),
            np.asarray(scene.images[tr].reshape(-1, 3)))
    views = [(np.asarray(scene.images[v]), np.asarray(scene.poses[v]),
              np.asarray(scene.intr[v])) for v in val]
    return rays, views


def _render_kw(variant):
    fused = variant == "brick3"
    return dict(n_coarse=128, n_samples=64, n_compact=20, near_distance=0.05,
                fused_march=fused, compact_source="grid" if fused else "network")


def _c2w(pose):
    R, t = pose[:, :3], pose[:, 3]
    return np.concatenate([R.T, (-R.T @ t[:, None]) * 0.33 + 0.5], 1).astype(np.float32)


def _train_jax(rays, views, variant, bf16):
    from myc_nerfs_tpu.models import ngp
    from myc_nerfs_tpu.render.ngp_render import NGPRenderConfig
    from myc_nerfs_tpu.train.ngp_trainer import NGPTrainConfig, NGPTrainer
    from myc_nerfs_tpu.utils.metrics import psnr

    o, d, rgb = rays
    t = NGPTrainer(ngp.NGPModelConfig(grid=ngp.HashGridConfig(), use_bf16=bf16,
                                      grid_impl=variant),
                   NGPRenderConfig(**_render_kw(variant)),
                   NGPTrainConfig(lr=1e-2, n_rays_per_batch=BATCH, n_grid_uniform=GRID,
                                  n_grid_nonuniform=GRID), jax.random.PRNGKey(0))
    key, rng = jax.random.PRNGKey(1), np.random.default_rng(0)
    for _ in range(0, STEPS, 16):
        key, k1, k2 = jax.random.split(key, 3)
        t.state = t.state._replace(occ=t.grid_update(t.state.occ, t.state.params, k1))
        ids = rng.integers(0, o.shape[0], (16, BATCH))
        t.train_block(o[ids], d[ids], rgb[ids], k2)
    return [float(psnr(jnp.clip(t.render_image(jnp.asarray(_c2w(pose)), jnp.asarray(intr),
                                                SIZE, SIZE, chunk=SIZE * SIZE)[0], 0, 1),
                       jnp.asarray(img)))
            for img, pose, intr in views]


def _train_port(rays, views, variant, bf16):
    from myc_nerfs_tpu_torch.models import ngp
    from myc_nerfs_tpu_torch.render.ngp_render import NGPRenderConfig
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainConfig, NGPTrainer
    from myc_nerfs_tpu_torch.utils.metrics import psnr

    o, d, rgb = rays
    gen = torch.Generator().manual_seed(0)
    t = NGPTrainer(ngp.NGPModelConfig(grid=ngp.HashGridConfig(), use_bf16=bf16,
                                      grid_impl=variant),
                   NGPRenderConfig(**_render_kw(variant)),
                   NGPTrainConfig(lr=1e-2, n_rays_per_batch=BATCH, n_grid_uniform=GRID,
                                  n_grid_nonuniform=GRID), gen, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(0, STEPS, 16):
        t.state = t.state._replace(occ=t.grid_update(t.state.occ, gen))
        ids = rng.integers(0, o.shape[0], (16, BATCH))
        t.train_block(o[ids], d[ids], rgb[ids], generator=gen)
    return [float(psnr(torch.clamp(t.render_image(torch.from_numpy(_c2w(pose)),
                                                  torch.from_numpy(intr.copy()), SIZE, SIZE,
                                                  chunk=SIZE * SIZE)[0], 0, 1),
                       torch.from_numpy(img.copy())))
            for img, pose, intr in views]


@pytest.mark.slow
@pytest.mark.parametrize("variant,bf16", [("brick3", False), ("brick3", True),
                                          ("hash", False)],
                         ids=["f32", "bf16", "hash-f32"])
def test_port_and_jax_reach_the_same_val_psnr(variant, bf16):
    torch.set_num_threads(2)
    rays, views = _scene()
    out = {}
    for name, train in (("jax", _train_jax), ("port", _train_port)):
        t0 = time.time()
        ps = train(rays, views, variant, bf16)
        out[name] = float(np.mean(ps))
        print(json.dumps({"which": name, "variant": variant, "bf16": bf16, "steps": STEPS,
                          "val_psnr": out[name], "val_psnrs": ps, "s": time.time() - t0}),
              flush=True)
    assert abs(out["port"] - out["jax"]) <= GATE_NOISE_DB
