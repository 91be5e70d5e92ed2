"""Where a train step's f32 gradients on the card leave its f64 ones, module
by module.

    python -m mafyolo_tpu_torch.tools.grad_check [--graph yolov6n-office] [--out DIR]

The step is the one chip_smoke.py's office_train_check holds card against
CPU (step_card_vs_cpu): random train weights from seed 3, two 160 px images
and their targets from seed 7, one accumulate-only TAL step. Its f64 run on
the CPU is the reference. One JSON line each:
  grad_check_step   each gradient leaf's distance from the f64 step's,
                    max |g - g64| / max(max |g64 leaf|, 1e-2 * the largest
                    leaf magnitude), for the card in f32 with cuDNN as it is,
                    with cudnn.deterministic, and with cuDNN off (PyTorch's
                    own CUDA convolutions and batch norm), and for the CPU in
                    f32: the worst leaves and layer 20's worst;
  grad_check_trace  the card's f32 step against f64 module by module, in
                    the order the backward reaches them: each module's
                    input and output gradient, and the first whose output
                    gradient is off by more than 1e-3, with the loss
                    components of both; and the modules whose input is 0 on
                    one side only (a ReLU gate the two precisions set
                    apart), with the f64 value there over the tensor's
                    largest;
  grad_check_layers every module with parameters of its own run alone on
                    the f64 step's own input and output gradient at that
                    module: its input and parameter gradients in f32 on the
                    card (cuDNN as it is) and on the CPU against f64 (max
                    |g - g64| / max |g64|), the modules ranked by the card's
                    error over the CPU's;
  grad_check_algo   the engine configurations cuDNN's own log shows it
                    finalized for the first-ranked convolution's forward
                    and backward on the card, run in a child process with
                    cuDNN's logging switched on.
TF32 is off throughout. Runs on the card; the card is required.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

NC = 80
CL = torch.channels_last


def _leaf_errors(got, want, floor=1e-2):
    top = max(w.abs().max().item() for w in want.values())
    return {k: ((got[k] - w).abs().max() / max(w.abs().max().item(), floor * top)).item()
            for k, w in want.items()}


def _model(graph, variables, device, dtype):
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.bridge import train_variables_to_state_dict
    m = build_model(graph, nc=NC)
    m.load_state_dict(train_variables_to_state_dict(variables))
    return m.to(device, dtype).to(memory_format=CL)


def _own_modules(model):
    """(name, module) of every module that holds parameters of its own."""
    return [(n, m) for n, m in model.named_modules()
            if n and any(True for _ in m.parameters(recurse=False))]


def step(graph, variables, imgs, targets, device, dtype, record=False):
    """(gradients by name, on the CPU in f64; {module name: [input, output
    gradient]} if record, in the order the backward reached the modules;
    the model; the loss components) of one accumulate-only step."""
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    m = _model(graph, variables, device, dtype)
    seen, hooks, order = {}, [], []
    if record:
        for name, mod in _own_modules(m):
            def fwd(mod, args, out, name=name):
                seen[name] = [args[0].detach().clone()]

            def bwd(mod, grad_in, grad_out, name=name):
                seen[name].append(grad_out[0].detach().clone())
                order.append(name)
            hooks += [mod.register_forward_hook(fwd), mod.register_full_backward_hook(bwd)]
    st = init_train_state(m, weight_decay=5e-4)
    met = make_train_step(num_classes=NC, img_size=imgs.shape[1])(
        st, imgs.to(device), targets.to(device), 0.01, 0.01, 0.01, 0.9, False, False,
        epoch_num=4)
    for h in hooks:
        h.remove()
    grads = {n: p.grad.detach().to("cpu", torch.float64) for n, p in m.named_parameters()}
    return (grads, {k: seen[k] for k in dict.fromkeys(order) if len(seen.get(k, ())) == 2}, m,
            {k: float(v) for k, v in met.items()})


def trace(seen32, seen64):
    """Each module's input (forward) and output gradient (backward) in
    the card's f32 step against the f64 step's, max |a - b| / max |b|, in
    the order the backward reached them: the first module whose output
    gradient is off by more than 1e-3 is where the backward left f64."""
    def rel(a, b):
        return ((a.double().cpu() - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()
    def flips(a, b):
        """Elements that are 0 on one side only (a ReLU's gate that the
        two precisions set apart), and the largest |f64 value| among them
        over max |f64|."""
        a = a.double().cpu()
        off = (a == 0) != (b == 0)
        return int(off.sum()), ((b.abs() * off).max() / b.abs().max().clamp_min(1e-300)).item()
    rows = [{"module": k, "input": rel(seen32[k][0], x64), "output_grad": rel(seen32[k][1], g64),
             "input_zero_flips": flips(seen32[k][0], x64)}
            for k, (x64, g64) in seen64.items() if k in seen32]
    first = next((r for r in rows if r["output_grad"] > 1e-3), None)
    return {"modules": len(rows), "backward_first": rows[:12], "first_off": first,
            "forward_input_max": max(r["input"] for r in rows),
            "worst_output_grad": sorted(rows, key=lambda r: -r["output_grad"])[:8],
            "zero_flips": [r for r in rows if r["input_zero_flips"][0]][:12]}


def local_grads(mod, x, go):
    """{"input": dx, parameter name: its gradient} of mod alone at x with
    output gradient go (a copy of mod; train mode as in the step)."""
    mod = copy.deepcopy(mod)
    for p in mod.parameters():
        p.grad = None
    x = x.detach().requires_grad_(True)
    mod(x).backward(go)
    return {"input": x.grad, **{n: p.grad for n, p in mod.named_parameters()}}


def layers(model64, seen, dev):
    """grad_check_layers' records, ranked."""
    mods = dict(_own_modules(model64))
    out = []
    for name, (x64, go64) in seen.items():
        ref = local_grads(mods[name], x64, go64)
        errs = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            mod = copy.deepcopy(mods[name]).to(d, torch.float32)
            fmt = CL if x64.dim() == 4 else torch.contiguous_format
            got = local_grads(mod, x64.to(d, torch.float32).contiguous(memory_format=fmt),
                              go64.to(d, torch.float32).contiguous(memory_format=fmt))
            errs[where] = {k: ((got[k].double().cpu() - r).abs().max()
                               / r.abs().max().clamp_min(1e-300)).item()
                           for k, r in ref.items() if r is not None}
        card, cpu = max(errs["card"].values()), max(errs["cpu"].values())
        out.append({"module": name, "type": type(mods[name]).__name__,
                    "input_shape": list(x64.shape), "card_f32": errs["card"],
                    "cpu_f32": errs["cpu"], "card_max": card, "cpu_max": cpu,
                    "ratio": card / max(cpu, 1e-30)})
    out.sort(key=lambda r: -r["ratio"])
    return out


def algo_child(path):
    """The child of grad_check_algo: one forward and backward of the saved
    convolution on the card, with cuDNN's logging set by the parent."""
    torch.backends.cudnn.allow_tf32 = False
    saved = torch.load(path)
    dev = torch.device("cuda")
    w = saved["weight"].to(dev).requires_grad_(True)
    b = None if saved["bias"] is None else saved["bias"].to(dev).requires_grad_(True)
    x = saved["x"].to(dev).contiguous(memory_format=CL).requires_grad_(True)
    y = F.conv2d(x, w, b, saved["stride"], saved["padding"], 1, saved["groups"])
    y.backward(saved["go"].to(dev).contiguous(memory_format=CL))
    torch.cuda.synchronize()


def algo(mod, x64, go64, out_dir):
    """cuDNN's log lines that name the engines of mod's backward on the
    card (mod a Conv2d)."""
    path = out_dir / "grad_check_conv.pt"
    torch.save({"weight": mod.weight.detach().float().cpu(),
                "bias": None if mod.bias is None else mod.bias.detach().float().cpu(),
                "stride": mod.stride, "padding": mod.padding, "groups": mod.groups,
                "x": x64.float().cpu(), "go": go64.float().cpu()}, path)
    log = out_dir / "cudnn_log.txt"
    env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3", CUDNN_LOGINFO_DBG="1",
               CUDNN_LOGDEST_DBG=str(log))
    proc = subprocess.run([sys.executable, "-m", "mafyolo_tpu_torch.tools.grad_check",
                           "--algo-child", str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    text = log.read_text(errors="replace") if log.exists() else ""
    found = re.findall(r'finalizeMode\W+(\w+).*?engineId\W+(\d+)\W+smVersion\W+\d+'
                       r'\W+knobChoices\W+\{([^}]*)\}', text)
    engines = list(dict.fromkeys((mode, int(eid), knobs.replace('\\"', "").replace(
        "CUDNN_KNOB_TYPE_", "")) for mode, eid, knobs in found))
    return {"rc": proc.returncode, "stderr_tail": proc.stderr[-400:], "log_bytes": len(text),
            "log": str(log), "engine_configs_finalized": engines[:60],
            "note": "the engine configurations cuDNN finalized for this convolution's "
                    "forward and backward (its heuristics' candidates, in order); the log "
                    "does not say which one ran"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", default="yolov6n-office")
    ap.add_argument("--out", default="chiprun_out/grad_check")
    ap.add_argument("--algo-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.algo_child:
        algo_child(args.algo_child)
        return
    if not torch.cuda.is_available():
        raise SystemExit("grad_check: needs a CUDA device")
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.office import OFFICE_CONFIGS, office_config_graph
    from mafyolo_tpu_torch.utils.bridge import random_train_variables
    from mafyolo_tpu_torch.utils.sample import train_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    graph = office_config_graph(args.graph) if args.graph in OFFICE_CONFIGS else args.graph
    variables = random_train_variables(build_model(graph, nc=NC).specs, seed=3)
    imgs, targets = train_batch(7, 2, 160, dev, nc=NC)

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    ref, seen, model64, loss64 = step(graph, variables, imgs, targets, "cpu", torch.float64,
                                      record=True)
    runs = {}
    for tag, where, det, enabled in (("card", dev, False, True),
                                     ("card_deterministic", dev, True, True),
                                     ("card_cudnn_off", dev, False, False),
                                     ("cpu_f32", "cpu", False, True)):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = det, enabled
        try:
            g, seen32, _, loss32 = step(graph, variables, imgs, targets, where, torch.float32,
                                        record=tag == "card")
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = False, True
        err = _leaf_errors(g, ref)
        worst = sorted(err.items(), key=lambda kv: -kv[1])
        l20 = [kv for kv in worst if ".layer20." in f".{kv[0]}" or "layer20." in kv[0]]
        runs[tag] = worst[0][1]
        emit(phase="grad_check_step", graph=args.graph, run=tag, leaves=len(err),
             max_rel_err=worst[0][1], worst=worst[:5], layer20_worst=l20[:3],
             loss_f32=loss32, loss_f64=loss64, tolerance_held_by_the_smoke=1e-2)
        if tag == "card":
            emit(phase="grad_check_trace", graph=args.graph, **trace(seen32, seen))
    ranked = layers(model64, seen, dev)
    emit(phase="grad_check_layers", graph=args.graph, modules=len(ranked), top=ranked[:12],
         layer20=[r for r in ranked if "layer20." in r["module"]][:8],
         note="card_f32 / cpu_f32: max |g - g64| / max |g64| of each gradient of the "
              "module alone on the f64 step's own input and output gradient")
    convs = [r for r in ranked if r["type"] == "Conv2d"]
    if convs:
        name = convs[0]["module"]
        emit(phase="grad_check_algo", module=name,
             **algo(dict(model64.named_modules())[name], *seen[name], out_dir))
    emit(phase="grad_check_done", runs=runs)


if __name__ == "__main__":
    main()
