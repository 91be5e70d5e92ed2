"""The port's FLOPs CLI (mafyolo_tpu_torch/tools/flops.py) against the JAX
package, on the CPU at 64 px: the params count equals JAX's
tools/flops.py:model_flops for N, S, M and office N in deploy and train
form (deploy N 3.76M, the paper's); the FLOPs equal twice the conv MACs of
JAX's lowered deploy graph (tools/graph_flops.py:conv_flops_from_hlo),
plus office N's two Transpose upsamples counted by hand (JAX computes them
as an einsum, which that parser does not read): 2 B H W Cin Cout 4 each.

JAX's deploy graph is lowered with MAFYOLO_FUSE_CONCAT=0: its concat fusion
(mafyolo_tpu/models/graph.py:247) commutes a 1x1 conv past a nearest
upsample and so does a quarter of those MACs; the port, like the
reference, convolves the upsampled concat. XLA's cost analysis, which the
JAX CLI prints, also counts elementwise work, so its FLOPs are not
compared (the CLI's docstring says so)."""
import importlib

import jax
import jax.numpy as jnp
import pytest

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.reparam import fold_variables as jax_fold_variables
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.office import office_config_graph
from mafyolo_tpu_torch.tools import flops as F

NC, IMG = 80, 64
NAMES = ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m", "yolov6n-office")


def _graph(name):
    return office_config_graph(name) if name.endswith("office") else name


@pytest.mark.parametrize("deploy", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_params_equal_jax_model_flops(name, deploy):
    jax_flops = importlib.import_module("tools.flops")
    _, want = jax_flops.model_flops(_graph(name), NC, IMG, deploy=deploy)
    _, got = F.model_flops(_graph(name), NC, IMG, deploy=deploy, device="cpu")
    assert got == want
    if name == "maf-yolo-n" and deploy:
        assert round(got / 1e6, 2) == 3.76


def _transpose_flops(graph):
    """2 B H W Cin Cout 4 of each Transpose row at IMG, B = 1: office N's
    first upsamples P5 (stride 32), its second P4 (stride 16)."""
    specs = [s for s in parse_graph(graph, nc=NC)[0] if s.kind == "Transpose"]
    assert len(specs) == 2
    return sum(2 * (IMG // stride) ** 2 * s.kw["cin"] * s.kw["cout"] * 4
               for s, stride in zip(specs, (32, 16)))


@pytest.mark.parametrize("name", NAMES)
def test_flops_equal_conv_macs_of_jax_graph(name, monkeypatch):
    graph_flops = importlib.import_module("tools.graph_flops")
    graph = _graph(name)
    tm = jax_build_model(graph, nc=NC)
    variables = jax.jit(tm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    model = jax_build_model(graph, nc=NC, deploy=True)
    monkeypatch.setenv("MAFYOLO_FUSE_CONCAT", "0")
    text = jax.jit(lambda v, x: model.apply(v, x, train=False)).lower(
        jax_fold_variables(tm.specs, variables), jnp.zeros((1, IMG, IMG, 3))).as_text()
    dw, dense = graph_flops.conv_flops_from_hlo(text)
    want = 2 * (dw + dense) + (_transpose_flops(graph) if name.endswith("office") else 0)
    got, _ = F.model_flops(graph, NC, IMG, deploy=True, device="cpu")
    assert got == want


def test_flops_cli_line(capsys):
    """The printed line, as the JAX CLI's."""
    line = F.main(["--graph", "maf-yolo-n", "--img-size", str(IMG), "--device", "cpu"])
    assert capsys.readouterr().out.strip() == line
    assert line.startswith(f"maf-yolo-n @{IMG}: params 3.76M, flops ")
    assert line.endswith("G (deploy form)")
