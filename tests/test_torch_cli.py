"""The port's CLI end to end on the CPU (as tests/test_cli_smoke.py holds
the JAX one): ``--tiny --device cpu`` over a folder of PNG frames twice
with one seed writes two identical GIFs (decode, the warmup split, the
stream lag, the writer); a video of no more than the warmup's 8 frames
exits with 2; the CLI asks for the card unless told otherwise; and
``--no-tiny-vae`` streams with the KL codec.
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from live2diff_tpu_torch import cli


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    vid = tmp_path_factory.mktemp("vid")
    rs = np.random.RandomState(0)
    base = rs.rand(64, 64, 3)
    for i in range(14):
        frame = np.clip(base + 0.05 * rs.rand(64, 64, 3), 0, 1)
        Image.fromarray((frame * 255).astype(np.uint8)).save(str(vid / f"{i:03d}.png"))
    return vid


def test_cli_twice_writes_identical_videos(frame_dir, tmp_path):
    outs = [tmp_path / "a.gif", tmp_path / "b.gif"]
    for out in outs:
        rc = cli.main([str(frame_dir), "configs/toonyou.yaml", "--tiny", "--device", "cpu",
                       "--seed", "11", "--output", str(out), "--prompt", "a cat"])
        assert rc == 0
        assert out.exists() and out.stat().st_size > 0
    assert outs[0].read_bytes() == outs[1].read_bytes()
    with Image.open(outs[0]) as gif:
        # 6 streamed frames, less the 3 of the stream lag (4 LCM steps)
        assert gif.n_frames == 3 and gif.size == (64, 64)


def test_cli_rejects_short_video(tmp_path):
    vid = tmp_path / "short"
    vid.mkdir()
    for i in range(8):
        Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(str(vid / f"{i}.png"))
    assert cli.main([str(vid), "configs/toonyou.yaml", "--tiny", "--device", "cpu"]) == 2


def test_cli_defaults_to_the_card():
    args = cli.build_argparser().parse_args(["v", "c.yaml", "--tiny"])
    assert args.device == "cuda"


def test_cli_streams_with_the_kl_codec(frame_dir, tmp_path, monkeypatch):
    """--no-tiny-vae builds SD-1.5's AutoencoderKL in place of TAESD."""
    from live2diff_tpu_torch import wrapper
    from live2diff_tpu_torch.models.vae import AutoencoderKL

    built = []
    build = wrapper.build_pipeline
    monkeypatch.setattr(wrapper, "build_pipeline", lambda *a, **kw: built.append(
        build(*a, **kw)) or built[-1])
    out = tmp_path / "kl.gif"
    rc = cli.main([str(frame_dir), "configs/toonyou.yaml", "--tiny", "--device", "cpu",
                   "--no-tiny-vae", "--output", str(out)])
    assert rc == 0 and out.exists()
    assert isinstance(built[0].vae, AutoencoderKL)
    with Image.open(out) as gif:
        assert gif.n_frames == 3 and gif.size == (64, 64)
