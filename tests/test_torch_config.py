"""The port's absl-free flags (vidu4d_tpu_torch.config) against absl and the
JAX package's vidu4d_tpu.config: the reference opts.log of
tests/test_config_compat.py, an opts.log written by the JAX save_config()
(absl's own flags in it), the port's opts.log read back by a JAX run, and
absl's syntax case by case.

absl flags are process-global, so the JAX side runs in fresh interpreters
that print its get_config() as JSON; values must be equal (floats exactly:
both parse the same decimal strings).
"""

import json
import os
import subprocess
import sys

import pytest

from tests.test_config_compat import REFERENCE_OPTS_LOG
from vidu4d_tpu_torch import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# non-default values of every kind, and an absl flag in the command line
NON_DEFAULT = ["--fg_motion=gs-bob", "--num_rounds", "3", "--nogs_optim_warp",
               "--reset_steps=false", "--lambda_dist=0.25", "--test_iterations=1,2,3",
               "--checkpoint_iterations=", "--gs_init_mesh=s2/020-fg-geo.obj",
               "--learning_rate=3e-05", "--seed=7", "--verbosity=1"]


def _jax_config(code: str, cwd) -> dict:
    """Run ``code`` (which defines ``main``) under absl's app.run in a fresh
    interpreter; return the JSON it prints last."""
    prog = ("import json, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from absl import app\n"
            "import vidu4d_tpu.config as config\n" + code)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=str(cwd))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jax_reads(path, cwd) -> dict:
    """JAX get_config() of a run given ``--flagfile=path``, as the JAX
    render / export CLIs read an opts.log."""
    return _jax_config("def main(_):\n"
                       "    print(json.dumps(config.get_config()))\n"
                       f"app.run(main, argv=['prog', '--flagfile={path}'])\n", cwd)


def _assert_same_flags(jax_opts: dict, port_opts: dict):
    for name in config.TRAIN_FLAGS:
        assert port_opts[name] == jax_opts[name], (name, port_opts[name], jax_opts[name])
        assert type(port_opts[name]) is type(jax_opts[name]), name


def test_reference_opts_log_parses(tmp_path):
    """tests/test_config_compat.py's reference opts.log, with the values
    that test asserts of the JAX parse."""
    path = tmp_path / "opts.log"
    path.write_text(REFERENCE_OPTS_LOG)
    opts = config.parse_flags([f"--flagfile={path}"])
    assert opts["fg_motion"] == "gs-bob"
    assert opts["num_rounds"] == 20
    assert abs(opts["depth_wt"] - 1e-4) < 1e-12
    assert opts["tet_grid_size"] == 80
    assert opts["pixels_per_image"] == 4096 and opts["single_inst"] is True
    assert opts["test_iterations"] == ["7000", "30000"] and opts["load_suffix"] == ""
    assert opts["device"] == "cuda" and "gs_init_samples" not in opts


def test_jax_written_opts_log_parses_as_jax_reads_it(tmp_path):
    """An opts.log of the JAX save_config() (absl's own flags in it) gives
    the port every flag of its table as a JAX run reading it has it (list
    flags hold strings then, as absl parses them)."""
    _jax_config("def main(_):\n"
                "    config.save_config()\n"
                "    print('{}')\n"
                f"app.run(main, argv=['prog', '--logroot=lr', '--seqname=s', '--logname=l', "
                f"*{NON_DEFAULT!r}])\n", tmp_path)
    path = tmp_path / "lr" / "s-l" / "opts.log"
    assert "--verbosity=1" in path.read_text() and "--nologtostderr" in path.read_text()
    opts = config.parse_flags([f"--flagfile={path}"])
    _assert_same_flags(_jax_reads(path, tmp_path), opts)
    assert opts["gs_optim_warp"] is False and opts["test_iterations"] == ["1", "2", "3"]


def test_port_opts_log_reads_back_in_jax(tmp_path):
    """The port's save_config() output read by a JAX run gives it the
    port's values; --device is not written. (The
    JAX load_flags_from_file returns without setting a flag: absl's
    read_flags_from_files only expands the file, so the JAX CLIs read an
    opts.log through --flagfile, as here.)"""
    opts = config.parse_flags([f"--logroot={tmp_path}", "--seqname=s", "--logname=l",
                               "--device=cpu", *NON_DEFAULT])
    path = config.save_config(opts)
    text = open(path).read()
    assert "--device" not in text
    back = config.parse_flags([f"--flagfile={path}"])
    _assert_same_flags(_jax_reads(path, tmp_path), back)
    for name, (kind, _) in config.TRAIN_FLAGS.items():  # lists come back as strings
        want = [str(v) for v in opts[name]] if kind == config.L else opts[name]
        assert back[name] == want, name
    assert back["device"] == "cuda"
    noop = _jax_config("def main(_):\n"
                       f"    config.load_flags_from_file({path!r})\n"
                       "    print(json.dumps(config.get_config()))\n"
                       "app.run(main, argv=['prog'])\n", tmp_path)
    assert noop["fg_motion"] == "rigid" != opts["fg_motion"]


@pytest.mark.parametrize("argv, name, value", [
    (["--gs_optim_warp"], "gs_optim_warp", True),
    (["--nogs_optim_warp"], "gs_optim_warp", False),
    (["--nogs_optim_warp", "--gs_optim_warp=true"], "gs_optim_warp", True),
    (["--rgb_loss_only=1"], "rgb_loss_only", True),
    (["--single_inst=0"], "single_inst", False),
    (["--single_inst=False"], "single_inst", False),
    (["--nowarp"], "nowarp", True),
    (["--nonowarp"], "nowarp", False),
    (["--no_loss_mask"], "no_loss_mask", True),
    (["--seqname", "cheetah"], "seqname", "cheetah"),
    (["--seed", "-1"], "seed", -1),
    (["-train_res=512"], "train_res", 512),
    (["--lambda_dist", "1e-3"], "lambda_dist", 1e-3),
    (["--save_iterations=7,8"], "save_iterations", ["7", "8"]),
    (["--save_iterations="], "save_iterations", []),
    (["--load_suffix="], "load_suffix", ""),
    (["--logtostderr", "--stderrthreshold=fatal", "--verbosity", "2"], "seqname", "cat"),
])
def test_flag_syntax(argv, name, value):
    opts = config.parse_flags(argv, config.RENDER_FLAGS)
    assert opts[name] == value and type(opts[name]) is type(value)


def test_nested_flagfiles_later_flags_win(tmp_path):
    """--flagfile expands in place, recursively: a flag after it overrides
    the file's, the file's override flags before it; comments and blank
    lines are skipped; a file that includes itself is read once."""
    inner = tmp_path / "inner.log"
    outer = tmp_path / "outer.log"
    inner.write_text("# comment\n\n--num_rounds=5\n--seqname=inner\n// comment\n")
    outer.write_text(f"--seqname=outer\n--flagfile={inner}\n--train_res=64\n"
                     f"--flagfile={outer}\n")
    opts = config.parse_flags(["--num_rounds=1", "--train_res=32", "--flagfile", str(outer),
                               "--train_res=128"])
    assert (opts["num_rounds"], opts["seqname"], opts["train_res"]) == (5, "inner", 128)


@pytest.mark.parametrize("argv", [
    ["--not_a_flag=1"], ["--nonot_a_flag"], ["--noseqname"], ["--gs_optim_warp=maybe"],
    ["--nogs_optim_warp=true"], ["--train_res=abc"], ["--seqname"], ["positional"],
    ["--viewpoint=ref"], ["--gs_init_samples=5"],
])
def test_bad_flags_raise(argv):
    """Unknown flags (--viewpoint is the render CLI's, not train's;
    gs_init_samples is an option of the JAX trainer that its CLI does not
    define), malformed values, a missing value and positional arguments
    raise."""
    with pytest.raises(ValueError):
        config.parse_flags(argv)
