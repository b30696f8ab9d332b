"""The port's ``compare_models`` and ``create_plots`` against the JAX
package's, on the CPU.

Two tiny experiments (GAT3D with the conv and the linear mapping, 16x16,
V = 6) are trained by the port for an epoch of 2 steps on a small
synthetic KNMI archive; each experiment directory gets a ``config.py``,
the port's ``model.pt`` and, for JAX, the same weights as
``model.msgpack`` (``to_flax``, then JAX's ``save_model``). Both
harnesses then compare the two on the archive's test split (the loaders
on their C++ batch path, which feeds both packages the same bytes):
every key of ``results.json`` but the times agrees within ``METRIC_RTOL``
(the evals differ only in float32 summation order; ``n_parameters``
exactly), ``results.html`` has the same table with the numbers masked,
and both draw ``multi_model_plot.png`` and ``pred_0.png``.
``create_plots`` draws ``comparison_plot.png`` from the same directories,
and a directory without ``model.pt`` raises in both harnesses.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from convolutional_gat.compare_models import __main__ as jax_compare
from convolutional_gat import create_plots as jax_create_plots
from extended_gan_tpu.data import native as jax_native
from extended_gan_tpu.train.checkpoint import save_model as jax_save_model
from extended_gan_torch import create_plots
from extended_gan_torch.compare_models import __main__ as compare
from extended_gan_torch.data import synthetic
from extended_gan_torch.train.gat_driver import train
from test_torch_port_gat_family import one_torch_thread, to_flax  # noqa: F401 - the autouse fixture

HW = 16
METRIC_RTOL = 1e-5
EXPERIMENTS = {"exp_conv": "conv", "exp_linear": "linear"}
CONFIG = """MODEL_TYPE = "temporal"
MAPPING_TYPE = "{mapping}"
DATASET = "kmni"
DOWNSAMPLE_SIZE = ({hw}, {hw})
"""


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """(the archive, the experiments' base folder)."""
    assert jax_native.available()
    root = tmp_path_factory.mktemp("compare")
    knmi = synthetic.make_kmni_dataset(str(root / "knmi"), hw=HW,
                                       frames_per_file=24)
    base = root / "experiments"
    for name, mapping in EXPERIMENTS.items():
        run = root / "runs" / name
        model, _ = train(model_type="temporal", mapping_type=mapping,
                         dataset="kmni", preprocessed_folder=knmi,
                         downsample_size=(HW, HW), epochs=1, max_batches=2,
                         train_batch_size=4, test_batch_size=8,
                         output_path=str(run), device="cpu")
        exp = base / name
        exp.mkdir(parents=True)
        (exp / "config.py").write_text(CONFIG.format(mapping=mapping, hw=HW))
        shutil.copy(run / "model.pt", exp / "model.pt")
        jax_save_model(str(exp / "model.msgpack"), *to_flax(model))
    return knmi, base


@pytest.fixture(scope="module")
def both(experiments, tmp_path_factory):
    """Each harness's output folder."""
    knmi, base = experiments
    out = tmp_path_factory.mktemp("out")
    kw = dict(downsample_size=(HW, HW), preprocessed_folder=knmi,
              dataset="kmni")
    compare.compare_models(str(base), list(EXPERIMENTS),
                           out_path=str(out / "port"), device="cpu", **kw)
    jax_compare.compare_models(str(base), list(EXPERIMENTS),
                               out_path=str(out / "jax"), **kw)
    return out / "port", out / "jax"


def _results(folder):
    with open(folder / "results.json") as f:
        return json.load(f)


def test_results_json_agrees_with_jax(both):
    port, jax = (_results(f) for f in both)
    assert list(port) == list(jax) == list(EXPERIMENTS)
    for name in EXPERIMENTS:
        assert list(port[name]) == list(jax[name])
        times = port[name]
        assert times["eval_time_s"] > 0 and np.isclose(
            times["eval_time_s"], 1000 * times["forward_pass_time_s"])
        for k, want in jax[name].items():
            got = port[name][k]
            if k in ("forward_pass_time_s", "eval_time_s"):
                continue
            if k == "n_parameters":
                assert got == want, name
            else:
                np.testing.assert_allclose(got, want, rtol=METRIC_RTOL,
                                           atol=1e-9, err_msg=f"{name} {k}")


def test_results_html_has_jax_table(both):
    port, jax = ((f / "results.html").read_text() for f in both)

    def layout(html):
        return re.sub(r"-?\d+\.\d{5}", "#", html)

    assert layout(port) == layout(jax)
    assert port.count("<tr>") == len(_results(both[0])["exp_conv"])


def test_both_harnesses_draw_the_same_figures(both):
    port, jax = both
    for f in ("multi_model_plot.png", "pred_0.png"):
        assert (jax / f).is_file() and (port / f).is_file(), f


def test_create_plots_draws_the_comparison(experiments, tmp_path):
    knmi, base = experiments
    dirs = [str(base / n) for n in EXPERIMENTS]
    got = create_plots.create_comparison_plot(
        dirs, preprocessed_folder=knmi, downsample_size=(HW, HW),
        out_file=str(tmp_path / "port.png"), device="cpu")
    want = jax_create_plots.create_comparison_plot(
        dirs, preprocessed_folder=knmi, downsample_size=(HW, HW),
        out_file=str(tmp_path / "jax.png"))
    assert got == str(tmp_path / "port.png") and os.path.isfile(got)
    assert want == str(tmp_path / "jax.png")


def test_a_missing_checkpoint_raises(experiments, tmp_path):
    knmi, base = experiments
    empty = tmp_path / "exp_none"
    empty.mkdir()
    shutil.copy(base / "exp_conv" / "config.py", empty / "config.py")
    kw = dict(downsample_size=(HW, HW), preprocessed_folder=knmi,
              dataset="kmni")
    with pytest.raises(ValueError, match="model.pt"):
        compare.compare_models(str(tmp_path), ["exp_none"],
                               out_path=str(tmp_path / "out"), device="cpu",
                               **kw)
    with pytest.raises(ValueError, match="model.msgpack"):
        jax_compare.compare_models(str(tmp_path), ["exp_none"],
                                   out_path=str(tmp_path / "out"), **kw)
    with pytest.raises(ValueError, match="model.pt"):
        create_plots.create_comparison_plot(
            [str(empty)], preprocessed_folder=knmi,
            downsample_size=(HW, HW), device="cpu")
