"""The trainer (counterpart of mafyolo_tpu/core/engine.py:34-426).

Trainer(args, cfg, data_dict).train(): build the train-form model and the
train loader (host augmentation, or letterbox only with --device-aug and
the augmentation in the step, data/device_aug.py), scale the solver, load
--pretrained (shape-matched) or --resume, then per epoch: the steps with
warm-up, accumulation and the ATSS -> TAL switch (core/train_state.py),
mosaic off for the last stop_aug_last_n_epoch epochs, the EMA evaluated by
run_eval on its schedule, last/best/best_stop_aug checkpoints in the JAX
package's file layout (utils/checkpoint.py), and at the end the stripped
checkpoints. TensorBoard and wandb mirror the scalars where installed.

It runs on the card unless the caller passes device="cpu". Data parallel
(the JAX package's 'data' mesh): when the process group is up
(parallel/ddp.py), each rank loads its shard of every global batch
(--batch-size stays the global batch), the train step is the global
batch's (core/train_state.py), the model starts from rank
0's weights, and only rank 0 evaluates, saves checkpoints and logs.

The training recipes of the JAX Trainer (engine.py:52-76, 137-204): any
iou_type of the config's head (Wise-IoU's running mean is state, saved
and resumed) and use_dfl; --simota (or cfg.model.target 'SimOTA') trains
the SimOTA loss of a Head_simota graph; --distill distills from the
checkpoint at --teacher-model-path (its meta.graph and its EMA, the
weights an eval reads); training_mode='repopt' trains the plain graph
under gradient masks from cfg.model.scales (solver/repopt.py), the
kernels re-initialized from the scales unless --pretrained. A config whose
model has build_type other than 'yaml' trains a YOLOv6 office graph
(EfficientRep or CSPBep, RepPAN, EffiDeHead), which models/office.py:
office_graph writes from the model section and the config's training_mode
(engine.py:52-58); its checkpoints carry that graph dict as meta.graph.
--remat builds the model with per-block rematerialization
(models/graph.py:GraphNet, policy "full"), as JAX's engine.py:72-75 does.
"""
from __future__ import annotations

import itertools
import os
import os.path as osp
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mafyolo_tpu_torch.core.evaler import run_eval
from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
from mafyolo_tpu_torch.data.datasets import DetectionDataset
from mafyolo_tpu_torch.data.loader import create_dataloader
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.office import office_graph
from mafyolo_tpu_torch.parallel import ddp
from mafyolo_tpu_torch.solver.build import build_lr_fn, warmup_schedule
from mafyolo_tpu_torch.solver.repopt import load_scales, repopt_prepare
from mafyolo_tpu_torch.utils.bridge import (state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from mafyolo_tpu_torch.utils.checkpoint import (eval_variables, find_latest_checkpoint,
                                                load_checkpoint, load_shape_matched,
                                                save_checkpoint, strip_checkpoint)
from mafyolo_tpu_torch.utils.events import LOGGER


class Schedule:
    """The solver scaling of one run (engine.py:79-84, 118-121; batch_size
    is the global batch, world_size the data-parallel ranks) and its step
    plan: warm-up lr and momentum, gradient accumulation (engine.py:305-312)."""

    def __init__(self, solver, batch_size: int, epochs: int, max_stepnum: int,
                 world_size: int = 1):
        self.solver = solver
        self.batch_size, self.max_stepnum = batch_size, max_stepnum
        accumulate = max(1, round(64 / batch_size))
        self.weight_decay = solver["weight_decay"] * batch_size * accumulate / 64
        self.lr0 = solver["lr0"] * batch_size / (world_size * 32)
        self.lf = build_lr_fn(solver["lr_scheduler"], solver["lrf"], epochs)
        self.warmup_stepnum = max(round(solver["warmup_epochs"] * max_stepnum), 1000) \
            if solver["warmup_epochs"] else 0
        self.last_opt_step = -1

    def lrs(self, step: int, epoch: int) -> Dict:
        """warmup_schedule at step `step` of `epoch` (no state)."""
        s = self.solver
        return warmup_schedule(step + self.max_stepnum * epoch, self.warmup_stepnum, epoch,
                               self.lf, self.lr0, self.batch_size, s["warmup_bias_lr"],
                               s["warmup_momentum"], s["momentum"])

    def plan(self, step: int, epoch: int):
        """-> (schedule dict, do_apply) for step `step` of `epoch`; records an
        apply step."""
        curr_step = step + self.max_stepnum * epoch
        sched = self.lrs(step, epoch)
        do_apply = (curr_step - self.last_opt_step) >= sched["accumulate"]
        if do_apply:
            self.last_opt_step = curr_step
        return sched, do_apply


class Trainer:
    """args: the train CLI's namespace (tools/train.py); cfg: a
    utils/config.py Config; data_dict: the dataset yaml's dict. dataset_cls
    builds the train and val datasets from data_dict's entries
    (utils/sample.py:ArrayDataset takes arrays there)."""

    def __init__(self, args, cfg, data_dict: Dict, *, device="cuda",
                 dataset_cls=DetectionDataset):
        self.args = args
        self.cfg = cfg
        self.data_dict = data_dict
        self.device = torch.device(device)
        self.dataset_cls = dataset_cls
        self.img_size = args.img_size
        self.batch_size = args.batch_size          # global batch
        self.rank, self.world = ddp.rank(), ddp.world_size()
        if self.batch_size % self.world:
            raise ValueError(f"the world size {self.world} must divide the global batch "
                             f"size {self.batch_size}")
        self.epochs = args.epochs
        self.nc = int(data_dict["nc"])
        self.save_dir = args.save_dir
        self.main = ddp.is_main_process()
        os.makedirs(self.save_dir, exist_ok=True)

        # repopt trains the plain (RealVGG) graph under gradient masks
        self.training_mode = cfg.get("training_mode", "repvgg")
        if cfg.model.get("build_type", "yaml") != "yaml":
            # the office path: the YOLOv6 topology written as a graph dict
            self.graph = office_graph(cfg.model, self.training_mode)
        else:
            self.graph = getattr(cfg.model, "graph", None) or cfg.model.get(
                "yaml_file", "maf-yolo-n")
        head = cfg.model.head
        self.dtype = torch.bfloat16 if getattr(args, "bf16", True) and \
            self.device.type != "cpu" else torch.float32
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            model = build_model(self.graph, nc=self.nc, reg_max=head.reg_max,
                                strides=tuple(head.strides),
                                remat=bool(getattr(args, "remat", False)),
                                plain_rep=self.training_mode == "repopt")

        hyp = dict(cfg.data_aug)
        self.device_aug = None
        host_augment = True
        if getattr(args, "device_aug", False):
            # the host loader only letterboxes; affine, HSV, flips, mosaic and
            # mixup run in the step
            self.device_aug = dict(
                degrees=float(hyp.get("degrees", 0.0)),
                translate=float(hyp.get("translate", 0.1)),
                scale=float(hyp.get("scale", 0.5)),
                shear=float(hyp.get("shear", 0.0)),
                hsv_h=float(hyp.get("hsv_h", 0.015)),
                hsv_s=float(hyp.get("hsv_s", 0.7)),
                hsv_v=float(hyp.get("hsv_v", 0.4)),
                fliplr=float(hyp.get("fliplr", 0.5)),
                flipud=float(hyp.get("flipud", 0.0)),
                mosaic=float(hyp.get("mosaic", 0.0)),
                mixup=float(hyp.get("mixup", 0.0)),
                dy_label=int(hyp.get("dy_label", 5)),
                dy_mixup=float(hyp.get("dy_mixup", 0.0)))
            host_augment = False
        self.train_loader, self.train_dataset = self._loader(hyp, host_augment)
        self.max_stepnum = len(self.train_loader)
        self.schedule = Schedule(cfg.solver, self.batch_size, self.epochs, self.max_stepnum,
                                 self.world)

        if getattr(args, "pretrained", None):
            ckpt = load_checkpoint(args.pretrained)
            params = state_dict_to_train_variables(dict(model.named_parameters()))["params"]
            matched = load_shape_matched(params, ckpt["model"]["params"])
            model.load_state_dict(train_variables_to_state_dict({"params": matched}),
                                  strict=False)
        self.grad_mask = None
        if self.training_mode == "repopt":
            # scales from the hyper-search checkpoint; reinit only when
            # training from scratch (engine.py:137-160)
            scales_path = cfg.model.get("scales")
            if not scales_path:
                raise ValueError("training_mode='repopt' needs cfg.model.scales "
                                 "(hyper-search checkpoint with LinearAddBlock scales)")
            scales = load_scales(scales_path)
            masks = repopt_prepare(model, scales, np.random.default_rng(args.seed),
                                   reinit=not getattr(args, "pretrained", None))
            self.grad_mask = {n: m.to(self.device) for n, m in masks.items()}
            LOGGER.info(f"repopt: {len(scales)} plain RepVGG convs "
                        f"re-initialized and grad-masked")
        model = model.to(self.device).to(memory_format=torch.channels_last)
        if self.world > 1:
            ddp.broadcast_state(model)
        # the EMA starts as a copy of the (pretrained) model
        self.state = init_train_state(model, weight_decay=self.schedule.weight_decay,
                                      lr0=self.schedule.lr0,
                                      momentum=cfg.solver["momentum"])
        self.start_epoch = 0
        if getattr(args, "resume", None):
            path = args.resume if isinstance(args.resume, str) else \
                find_latest_checkpoint(self.save_dir)
            if path:
                self._resume(load_checkpoint(path))
                LOGGER.info(f"resumed from {path} at epoch {self.start_epoch}")
        self.loss_type = "simota" if (getattr(args, "simota", False)
                                      or cfg.model.get("target") == "SimOTA") else "tal"
        self.teacher = None
        if getattr(args, "distill", False):
            self.teacher = self._teacher(args.teacher_model_path)
            self.loss_type = "distill"
        self.train_step = self._make_train_step()

        self.warmup_epoch_loss = int(getattr(head, "atss_warmup_epoch", 3))
        self.stop_aug_last_n_epoch = int(getattr(args, "stop_aug_last_n_epoch", 15))
        self.eval_interval = int(getattr(args, "eval_interval", 20))
        self.heavy_eval_range = int(getattr(args, "heavy_eval_range", 50))
        self.best_ap = 0.0
        self.best_stop_aug_ap = 0.0
        self.ap = 0.0
        self.tb = None
        if self.main and getattr(args, "tensorboard", True):
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(self.save_dir)
            except ImportError:
                LOGGER.info("tensorboard writer unavailable; skipping")
        self.wandb = None
        if self.main and getattr(args, "wandb", False):
            try:
                import wandb
                self.wandb = wandb
                wandb.init(project=getattr(args, "wandb_project", "mafyolo-tpu"),
                           dir=self.save_dir, config=vars(args))
            except Exception as e:  # noqa: BLE001 - wandb is an optional mirror
                LOGGER.warning(f"wandb unavailable ({e}); continuing without")

    def _loader(self, hyp, augment: bool):
        """This rank's loader: batches of batch_size / world from the
        rank::world stride of each epoch's order. Under data parallel a last
        partial batch is dropped, so every rank takes the same full batches."""
        loader, dataset = create_dataloader(
            self.data_dict["train"], self.img_size, self.batch_size // self.world, stride=32,
            hyp=hyp, augment=augment, workers=self.args.workers, shuffle=True,
            seed=self.args.seed, max_labels=getattr(self.args, "max_labels", 120),
            use_processes=getattr(self.args, "loader_processes", False),
            dataset_cls=self.dataset_cls, shard_id=self.rank, num_shards=self.world)
        loader.drop_last = loader.drop_last or self.world > 1
        return loader, dataset

    def _teacher(self, path: str) -> torch.nn.Module:
        """The distillation teacher: the train form of the checkpoint's
        meta.graph (else this run's graph) holding its eval weights (the
        EMA if any), in eval mode on this device (engine.py:183-195)."""
        head = self.cfg.model.head
        ckpt = load_checkpoint(path)
        graph = ckpt.get("meta", {}).get("graph", self.graph)
        teacher = build_model(graph, nc=self.nc, reg_max=head.reg_max,
                              strides=tuple(head.strides))
        teacher.load_state_dict(train_variables_to_state_dict(eval_variables(ckpt)))
        return teacher.to(self.device).to(memory_format=torch.channels_last).eval()

    def _make_train_step(self):
        head = self.cfg.model.head
        return make_train_step(
            num_classes=self.nc, img_size=self.img_size, strides=tuple(head.strides),
            reg_max=head.reg_max, use_dfl=head.use_dfl, iou_type=head.iou_type,
            dtype=self.dtype, device_aug=self.device_aug, seed=self.args.seed,
            loss_type=self.loss_type, teacher=self.teacher, max_epoch=self.epochs,
            distill_feat=bool(getattr(self.args, "distill_feat", False)),
            temperature=float(getattr(self.args, "temperature", 20.0)),
            grad_mask=self.grad_mask)

    # ---------- state <-> checkpoint ----------

    def _momentum(self) -> Dict[str, torch.Tensor]:
        """The SGD momentum of every parameter by name (zeros before the
        first apply step, as the JAX state's)."""
        opt = self.state.optimizer
        return {n: opt.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                for n, p in self.state.model.named_parameters()}

    def checkpoint(self, epoch: int) -> Dict:
        """The state as the JAX package's checkpoint dict (numpy leaves)."""
        head = self.cfg.model.head
        return {
            "model": state_dict_to_train_variables(self.state.model.state_dict()),
            "ema": state_dict_to_train_variables(self.state.ema.state_dict()),
            "opt": state_dict_to_train_variables(self._momentum())["params"],
            "updates": int(self.state.updates),
            # Wise-IoU's running mean (1.0 unless iou_type is 'wiou')
            "wiou_mean": float(self.state.wiou_mean),
            "epoch": epoch,
            "meta": {"graph": self.graph, "nc": self.nc, "img_size": self.img_size,
                     "reg_max": int(head.reg_max), "strides": list(head.strides)},
        }

    @torch.no_grad()
    def _resume(self, ckpt: Dict):
        """Model, EMA (if the checkpoint has one), momentum, updates,
        Wise-IoU's running mean and the epoch to start from."""
        model, state = self.state.model, self.state
        model.load_state_dict(train_variables_to_state_dict(ckpt["model"]))
        if ckpt.get("ema"):
            for k, v in train_variables_to_state_dict(ckpt["ema"]).items():
                state.ema.state[k].copy_(v)
        if ckpt.get("opt"):
            mom = train_variables_to_state_dict({"params": ckpt["opt"]})
            for n, p in model.named_parameters():
                state.optimizer.state[p]["momentum_buffer"] = \
                    torch.empty_like(p).copy_(mom[n])
        state.updates = int(ckpt.get("updates", 0))
        state.wiou_mean = torch.tensor(float(ckpt.get("wiou_mean", 1.0)),
                                       dtype=torch.float32, device=self.device)
        self.start_epoch = int(ckpt.get("epoch", -1)) + 1

    def _log_scalar(self, key: str, value, step: int):
        if self.tb:
            self.tb.add_scalar(key, value, step)
        if self.wandb:
            self.wandb.log({key: value}, step=step)

    # ---------- epoch orchestration ----------

    def train(self):
        t0 = time.time()
        try:
            for epoch in range(self.start_epoch, self.epochs):
                self.train_one_epoch(epoch)
                self.eval_and_save(epoch)
            LOGGER.info(f"training done in {(time.time() - t0) / 3600:.2f}h; "
                        f"best AP {self.best_ap:.4f}")
            if self.main:
                self.strip_models()
        except Exception:
            LOGGER.error("training failed")
            raise
        return self.best_ap

    def strip_models(self):
        """After the last epoch: EMA -> model and no optimizer state, in fp16,
        in the saved best/last/stop-aug checkpoints."""
        for name in ("best_ckpt", "last_ckpt", "best_stop_aug_ckpt"):
            path = osp.join(self.save_dir, f"{name}.npck")
            if osp.exists(path):
                strip_checkpoint(path)

    def prepare_for_steps(self, epoch: int):
        """The stop-aug tail: at its first epoch, device mosaic off (the step is
        rebuilt) and the loader rebuilt with host augmentation but no mosaic or
        mixup, in device-aug mode too, as the JAX trainer does
        (engine.py:278-294). Then the loader's epoch."""
        if epoch == self.epochs - self.stop_aug_last_n_epoch:
            if self.device_aug and self.device_aug.get("mosaic"):
                self.device_aug = dict(self.device_aug, mosaic=0.0)
                LOGGER.info("disabling device mosaic for the stop-aug tail")
                self.train_step = self._make_train_step()
            hyp = dict(self.cfg.data_aug)
            hyp.update(mosaic=0.0, mixup=0.0, dy_mixup=0.0)
            LOGGER.info("disabling mosaic/mixup for the stop-aug tail")
            self.train_loader, self.train_dataset = self._loader(hyp, True)
        self.train_loader.set_epoch(epoch)

    def _train_steps(self, epoch: int, batches: Iterable, mark=None) -> List[Dict]:
        """Run every (imgs_u8, targets) batch of `batches`, tensors on the
        model's device, as one train step of `epoch`, without the loader;
        -> each step's metrics (device tensors: nothing waits for the
        device). mark goes to the train step (core/train_state.py)."""
        return [self._step(epoch, step, batch, mark) for step, batch in enumerate(batches)]

    def _device_batches(self, epoch: int):
        """The loader's batches on the model's device, with the first-batch
        TensorBoard image and the --profile trace of steps 2-7 of the first
        epoch (a torch.profiler trace in save_dir/profile)."""
        prof = None
        profile = getattr(self.args, "profile", False) and epoch == self.start_epoch
        batches = itertools.islice(self.train_loader, self.max_stepnum)
        for step, (imgs, targets, _) in enumerate(batches):
            if profile and step == 2:
                from torch.profiler import ProfilerActivity, profile as torch_profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
                prof = torch_profile(activities=acts)
                prof.__enter__()
                LOGGER.info("torch.profiler trace started (steps 2-7)")
            elif prof is not None and step == 7:
                self._end_profile(prof)
                prof = None
            if step == 0 and self.tb and epoch % max(1, self.eval_interval) == 0:
                from mafyolo_tpu_torch.utils.plots import plot_train_batch
                grid = plot_train_batch(imgs, targets, names=self.data_dict.get("names"))
                self.tb.add_image("train_batch", grid[:, :, ::-1], epoch, dataformats="HWC")
            yield (torch.from_numpy(imgs).to(self.device),
                   torch.from_numpy(targets.astype(np.float32)).to(self.device))
        if prof is not None:
            self._end_profile(prof)

    def _end_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = osp.join(self.save_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(osp.join(out, "trace.json"))
        LOGGER.info(f"profiler trace -> {out}")

    def train_one_epoch(self, epoch: int, mark=None):
        """One epoch over the loader; -> the running mean of the metrics at
        its logged steps (every 50th). mark goes to the train step."""
        self.prepare_for_steps(epoch)
        running = None
        t_start = time.time()
        n_imgs = 0
        sched = self.schedule.lrs(0, epoch)
        for step, batch in enumerate(self._device_batches(epoch)):
            metrics = self._step(epoch, step, batch, mark)
            n_imgs += batch[0].shape[0] * self.world
            if step % 50 == 0 and self.main:
                sched = self.schedule.lrs(step, epoch)
                vals = {k: float(v) for k, v in metrics.items()}
                running = vals if running is None else {
                    k: 0.5 * running[k] + 0.5 * vals[k] for k in vals}
                ips = n_imgs / max(time.time() - t_start, 1e-9)
                LOGGER.info(
                    f"epoch {epoch} step {step}/{self.max_stepnum} "
                    + " ".join(f"{k}={v:.4f}" for k, v in running.items())
                    + f" lr={sched['lr_weight']:.5f} img/s={ips:.1f}")
        if (self.tb or self.wandb) and running:
            for k, v in running.items():
                self._log_scalar(f"train/{k}", v, epoch)
            self._log_scalar("train/lr", sched["lr_weight"], epoch)
            self._log_scalar("train/images_per_sec",
                             n_imgs / max(time.time() - t_start, 1e-9), epoch)
        return running

    def _step(self, epoch: int, step: int, batch, mark=None) -> Dict:
        sched, do_apply = self.schedule.plan(step, epoch)
        imgs, targets = batch
        return self.train_step(self.state, imgs, targets, sched["lr_bnw"],
                               sched["lr_weight"], sched["lr_bias"], sched["momentum"],
                               do_apply, epoch < self.warmup_epoch_loss, epoch_num=epoch,
                               mark=mark)

    # ---------- eval + checkpoint ----------

    def _should_eval(self, epoch: int) -> bool:
        if epoch == self.epochs - 1:
            return True
        remaining = self.epochs - 1 - epoch
        if remaining < self.heavy_eval_range:
            return (epoch + 1) % max(1, self.eval_interval // 7) == 0
        return (epoch + 1) % self.eval_interval == 0

    def eval_and_save(self, epoch: int) -> Optional[Dict]:
        """Evaluate the EMA when _should_eval says so (rect batches, as the
        reference's mid-train protocol), then write last_ckpt (and best_ckpt
        on a new best AP, best_stop_aug_ckpt in the tail). -> the eval's
        metrics, or None. Rank 0's alone: the other ranks return None."""
        if not self.main:
            return None
        do_eval = self._should_eval(epoch) and "val" in self.data_dict
        save_interval = int(getattr(self.args, "save_interval", 1))
        will_save = (do_eval or epoch % max(1, save_interval) == 0
                     or epoch >= self.epochs - self.stop_aug_last_n_epoch
                     or epoch == self.epochs - 1)
        if not will_save:
            return None
        ckpt = self.checkpoint(epoch)
        metrics = None
        if do_eval:
            def log_vis(imgs_rgb):
                for vi, im in enumerate(imgs_rgb):
                    self.tb.add_image(f"val_pred/{vi}", im, epoch, dataformats="HWC")

            metrics = run_eval(
                self.graph, ckpt["ema"], self.nc, self.data_dict, folded=False,
                img_size=self.img_size, rect=True,
                batch_size=min(self.batch_size * 2, 64), task="val",
                half=self.device.type != "cpu", workers=self.args.workers,
                on_vis=log_vis if self.tb else None, device=self.device,
                dataset_cls=self.dataset_cls)
            self.ap = metrics.get("AP", 0.0)
            if self.tb or self.wandb:
                for k, v in metrics.items():
                    self._log_scalar(f"val/{k}", v, epoch)
        is_best = self.ap > self.best_ap
        self.best_ap = max(self.ap, self.best_ap)
        save_checkpoint(ckpt, is_best, self.save_dir, "last_ckpt")
        if epoch >= self.epochs - self.stop_aug_last_n_epoch:
            if self.ap > self.best_stop_aug_ap:
                self.best_stop_aug_ap = self.ap
                save_checkpoint(ckpt, False, self.save_dir, "best_stop_aug_ckpt")
        if is_best:
            LOGGER.info(f"new best AP {self.best_ap:.4f} at epoch {epoch}")
        return metrics
