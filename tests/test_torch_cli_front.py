"""The port's front-end subcommands against the JAX package's CLI:
``crop-broad-player``, ``detect-players`` and ``crop-player`` with the
committed detector at 128×192 (its score threshold lowered to 1e-3, so
that boxes appear: the weights score the players of these small frames far
below 0.7) on a tree of synthetic frames from K3's mirror, and
``harvest-frames`` on an MJPG clip with the committed frame classifier,
each run with ``--device cpu`` in a subprocess whose imports refuse JAX.
Each prints the JSON that the JAX CLI prints on the same inputs, and the
two write the same file lists (``harvest-frames``: the same bytes)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.io import formats as jio  # noqa: E402

from test_torch_cli import front_argv, last_json, run_cli  # noqa: E402
from test_torch_crop_stages import synth_frames  # noqa: E402
from test_torch_scene_tree import tree_files  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def front_inputs(tmp_path_factory):
    """A frame tree (2 scenes of 256×384 synthetic frames, one with a
    second frame) and a per-view tree (players 1 and 2, one 96² view
    each)."""
    root = tmp_path_factory.mktemp("front")
    frames = synth_frames(b=3)
    for k, (scene, name) in zip((2, 0, 1), (("s1", "broad.png"),
                                            ("s2", "broad.png"),
                                            ("s2", "frame2.png"))):
        os.makedirs(root / "frames" / "g1" / scene, exist_ok=True)
        jio.write_png(str(root / "frames" / "g1" / scene / name), frames[k])
    for player in ("1", "2"):
        os.makedirs(root / "views" / "g1" / "s1" / player)
        jio.write_png(str(root / "views" / "g1" / "s1" / player / "v.png"),
                      frames[int(player)][16:112, 40:136])
    return root


def jax_cli_json(argv, capsys):
    from soccerplayershapepose_tpu.cli import main
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["crop-broad-player", "detect-players",
                                  "crop-player"])
def test_cli_detection_stages_match_jax(tmp_path, front_inputs, capsys,
                                        name):
    got = last_json(run_cli(*front_argv(name, front_inputs,
                                        tmp_path / "torch"),
                            "--device", "cpu"))
    want = jax_cli_json(front_argv(name, front_inputs, tmp_path / "jax"),
                        capsys)
    assert got == want
    assert tree_files(tmp_path / "torch") == tree_files(tmp_path / "jax")
    if name == "crop-broad-player":
        assert got["boxes"] > 0 and got["images"]["crops"] > 0


def test_cli_harvest_frames_matches_jax(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    video = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.RandomState(0)
    for i in range(12):
        w.write(rng.randint(0, 255, (48, 64, 3), np.uint8) if i % 3
                else np.full((48, 64, 3), (60, 150, 50), np.uint8))
    w.release()

    def argv(out):
        return ["harvest-frames", "--video", video, "--out-root", str(out),
                "--n-samples", "6", "--max-accepted", "4", "--seed", "3",
                "--height", "48", "--width", "64", "--classifier-params",
                os.path.join(REPO, "weights", "frame_classifier.npz")]

    got = last_json(run_cli(*argv(tmp_path / "torch"), "--device", "cpu"))
    want = jax_cli_json(argv(tmp_path / "jax"), capsys)
    assert got == want and got["videos"][0]["sampled"] <= 6
    files = tree_files(tmp_path / "torch")
    assert files == tree_files(tmp_path / "jax")
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
