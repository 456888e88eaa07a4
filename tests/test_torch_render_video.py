"""run_net --task render writes demo.mp4 beside the frames, as the JAX
package's run_net does (myc_nerfs_tpu/cli/run_net.py's render task,
through evaluation/visualization.write_video at 8 fps), or, without a
video encoder, the declared fallback: the frames as images under demo/."""
import os
import sys
import types

import numpy as np
import torch

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "ngp", "demo_synthetic.py")


def _render(out):
    from myc_nerfs_tpu_torch.cli import run_net

    run_net.main(["--config-file", CONFIG, "--task", "render", "--save_dir", str(out),
                  "--device", "cpu"])
    frames = sorted(p for p in os.listdir(out / "demo") if p.endswith(".npy"))
    assert len(frames) == 8 and frames[0] == "000.npy"
    return frames


def test_render_writes_video_with_an_encoder(tmp_path, monkeypatch):
    """With cv2 (a stand-in VideoWriter recording its calls): demo.mp4 at
    8 fps from the 8 frames, each BGR uint8 of the render's size."""
    written = {}

    class Writer:
        def __init__(self, path, fourcc, fps, size):
            written.update(path=path, fps=fps, size=size, frames=[])

        def isOpened(self):
            return True

        def write(self, frame):
            written["frames"].append(frame)

        def release(self):
            with open(written["path"], "wb") as f:
                f.write(b"\0" * 16)

    cv2 = types.SimpleNamespace(VideoWriter=Writer, VideoWriter_fourcc=lambda *c: 0)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    _render(tmp_path)
    assert written["path"] == os.path.join(str(tmp_path), "demo.mp4")
    assert os.path.getsize(tmp_path / "demo.mp4") > 0
    assert written["fps"] == 8 and len(written["frames"]) == 8
    rgb = np.load(tmp_path / "demo" / "000.npy")
    assert written["size"] == (rgb.shape[1], rgb.shape[0])
    np.testing.assert_array_equal(written["frames"][0][..., ::-1],
                                  (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def test_render_without_an_encoder_leaves_the_declared_fallback(tmp_path, monkeypatch):
    """Without cv2: no demo.mp4, and write_video's fallback frames (PNG with
    PIL, else .npy) in demo/ beside the numbered frames, which keep their
    names."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    _render(tmp_path)
    assert not os.path.exists(tmp_path / "demo.mp4")
    try:
        import PIL  # noqa: F401
        ext = ".png"
    except ImportError:
        ext = ".npy"
    fallback = sorted(p for p in os.listdir(tmp_path / "demo")
                      if p.endswith(ext) and len(p) == 4 + len(ext))
    assert fallback == [f"{i:04d}{ext}" for i in range(8)]
