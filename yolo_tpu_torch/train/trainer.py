"""The trainer (counterpart of ``yolo_tpu/train/trainer.py``): the
configuration, the LR schedule, the optimizer, the loss function, the
train step, the multi-scale buckets and the device-resident loop.

One step: uint8 or normalized NHWC images on the model's device, the
training forward (``detector.train_outputs``: BN in train mode, its
running stats moved in place), ``yolo_loss`` in float32, ``backward()``,
then SGD with momentum 0.9 and coupled weight decay 5e-4 over the whole
JAX-layout tree of the model, the BN running mean and variance included,
as the JAX package's optax chain runs it (``SGD``). Options: bf16
compute against float32 masters, a rematerialized forward, and the
pooled-resolution s2d form of the entry conv + pool pairs.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from yolo_tpu_torch import detector as det
from yolo_tpu_torch.config import TRAIN_CFG, DetectorConfig
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.train.loss import yolo_loss


@dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    wp_epoch: int = 2              # warmup epochs (reference train.py:47)
    max_epoch: int = TRAIN_CFG["max_epoch"]
    lr_epoch: Tuple[int, ...] = TRAIN_CFG["lr_epoch"]
    cos: bool = False
    obj_loss_f: str = "mse"
    # recompute the forward during the backward instead of keeping its
    # activations
    remat: bool = False
    # mixed precision: the convs in this dtype, the parameters,
    # gradients and the loss in float32
    compute_dtype: Optional[str] = None
    # conv + pool pairs with C_in <= this in the pooled-resolution s2d
    # form (same math, another summation order); 0: the plain trace
    fast_pool_cin: int = 0


def lr_at(tc: TrainConfig, epoch: int, iteration: int,
          epoch_size: int) -> float:
    """Learning rate for (epoch, iter): quartic warmup then step/cosine
    (reference train.py:255-281)."""
    if epoch < tc.wp_epoch:
        total = iteration + epoch * epoch_size
        return tc.base_lr * math.pow(total / (tc.wp_epoch * epoch_size), 4)
    if tc.cos:
        t, T = epoch, tc.max_epoch
        return 0.00001 + 0.5 * (tc.base_lr - 0.00001) * (
            1 + math.cos(math.pi * t / T))
    lr = tc.base_lr
    for step_epoch in tc.lr_epoch:
        if epoch >= step_epoch:
            lr *= 0.1
    return lr


def multi_scale_sizes(stride_mult: int = 32, low: int = 10, high: int = 19):
    """The reference multi-scale bucket list: random size in
    [10, 19] * 32 every 10 iterations (train.py:287-294)."""
    return [(s * stride_mult, s * stride_mult) for s in range(low, high + 1)]


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------


def tree_leaves(model):
    """[(path, tensor)] of ``model``'s JAX-layout tree in its order
    (``quant.convert.module_to_params``'s): each conv's 'w' (the live OIHW
    weight), 'b', and 'bn' {'gamma', 'beta', 'mean', 'var'} (the running
    stats are buffers); a path is the tuple of its keys, a list index as
    a string (flax's ``to_state_dict`` keys). A model that runs another
    one's forward (``quant.qat.QATModule``) has that one's tree
    (``tree_module()``), without a prefix of its own."""
    from yolo_tpu_torch.quant.convert import _BN_KEYS

    if hasattr(model, "tree_module"):
        model = model.tree_module()
    out = []

    def visit(m, path):
        if isinstance(m, blocks.Conv):
            out.append((path + ("w",), m.conv.weight))
            if m.conv.bias is not None:
                out.append((path + ("b",), m.conv.bias))
            if m.bn is not None:
                out.extend((path + ("bn", k), getattr(m.bn, a))
                           for k, a in _BN_KEYS)
            return
        children = (enumerate(m) if isinstance(m, torch.nn.ModuleList)
                    else m.named_children())
        for k, child in children:
            visit(child, path + (str(k),))

    visit(model, ())
    return out


def _to_jax_layout(path, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().copy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if path[-1] == "w" \
        else a


class SGDState:
    """The optimizer's state on the model's tensors, the layout of
    optax's ``inject_hyperparams(chain(add_decayed_weights, sgd))`` state:
    ``count`` (steps taken), ``learning_rate`` (the last step's), and a
    momentum ``trace`` per leaf of the tree (``tree_leaves``: parameters
    and BN running stats), in the leaf's own layout and type."""

    def __init__(self, leaves, learning_rate: float):
        self.paths = [p for p, _ in leaves]
        self.leaves = [t for _, t in leaves]
        self.trace = [torch.zeros_like(t) for t in self.leaves]
        self.count = 0
        self.learning_rate = float(learning_rate)

    def state_dict(self) -> dict:
        """flax's ``to_state_dict`` of the JAX package's optimizer state:
        {'count', 'hyperparams': {'learning_rate'}, 'hyperparams_states':
        {}, 'inner_state': {'0': {}, '1': {'0': {'trace': tree}, '1':
        {}}}}, the trace tree with the params' keys (a list as {'0': ..})
        and HWIO weights, numpy arrays."""
        trace: dict = {}
        for path, t in zip(self.paths, self.trace):
            node = trace
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _to_jax_layout(path, t)
        return {"count": np.asarray(self.count, np.int32),
                "hyperparams": {"learning_rate": np.asarray(
                    self.learning_rate, np.float32)},
                "hyperparams_states": {},
                "inner_state": {"0": {}, "1": {"0": {"trace": trace},
                                               "1": {}}}}

    def load_state_dict(self, sd) -> "SGDState":
        """Restore from ``state_dict``'s layout (either package's, e.g. a
        checkpoint's ``extra['opt_state']``) in place."""
        trace = sd["inner_state"]["1"]["0"]["trace"]
        with torch.no_grad():
            for path, t in zip(self.paths, self.trace):
                node = trace
                for k in path:
                    node = node[int(k)] if isinstance(node, list) else node[k]
                v = torch.as_tensor(np.array(node, np.float32))
                if path[-1] == "w":
                    v = v.permute(3, 2, 0, 1)
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"trace {'.'.join(path)}: shape "
                                     f"{tuple(v.shape)}, the model's "
                                     f"{tuple(t.shape)}")
                t.copy_(v)
        self.count = int(np.asarray(sd["count"]))
        self.learning_rate = float(np.asarray(
            sd["hyperparams"]["learning_rate"]))
        return self


class SGD:
    """SGD with momentum and torch-style (coupled) weight decay over the
    whole JAX-layout tree of a model, as the JAX package's
    ``make_optimizer`` chains ``optax.add_decayed_weights`` and
    ``optax.sgd``: per leaf ``trace = momentum * trace + (g + wd * p)``,
    then ``p -= lr * trace``, with ``p`` the leaf after the forward (the
    BN running stats after their EMA) and ``g`` its gradient, zero for the
    running stats, which no loss reads: they decay and carry momentum
    too. ``torch.optim.SGD`` over ``parameters()`` never touches buffers.
    The updates land in place under ``no_grad``, in the leaves' own type
    (float32 masters)."""

    def __init__(self, tc: TrainConfig):
        self.weight_decay = tc.weight_decay
        self.momentum = tc.momentum
        self.base_lr = tc.base_lr

    def init(self, model) -> SGDState:
        return SGDState(tree_leaves(model), self.base_lr)

    @torch.no_grad()
    def update(self, state: SGDState, lr: float) -> None:
        """One step on ``state``'s leaves with their ``.grad`` (none: 0)."""
        leaves, trace = state.leaves, state.trace
        u = torch._foreach_mul(leaves, self.weight_decay)
        with_grad = [(ui, p.grad) for ui, p in zip(u, leaves)
                     if p.grad is not None]
        if with_grad:
            torch._foreach_add_([ui for ui, _ in with_grad],
                                [g for _, g in with_grad])
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, u)
        torch._foreach_add_(leaves, torch._foreach_mul(trace, -float(lr)))
        state.count += 1
        state.learning_rate = float(lr)


# ---------------------------------------------------------------------------
# The loss and the step.
# ---------------------------------------------------------------------------


def _recompute_contexts():
    # torch.utils.checkpoint's (forward, recompute) contexts: the
    # recompute moves no BN running stat
    return contextlib.nullcontext(), blocks.frozen_stats()


def _train_forward(model, cfg: DetectorConfig, tc: TrainConfig):
    """The training forward of ``tc``'s form: normalized images ->
    (conf, cls, txtytwth, boxes_norm), in float32 under bf16 compute."""
    run = model
    cdt = getattr(torch, tc.compute_dtype) if tc.compute_dtype else None
    if cdt is not None:
        # bf16 copies of every parameter (gamma and beta too), whose
        # gradients flow back through the cast to the float32 masters;
        # the live buffers, so the running stats take their EMA in place
        # in float32 (the JAX package's _cast_tree(keep_bn_stats=True)
        # and _graft_bn_stats)
        tensors = {n: p.to(cdt) for n, p in model.named_parameters()}
        tensors.update(model.named_buffers())

        def run(x):
            return torch.func.functional_call(model, tensors, (x,))

    def fwd(x):
        pool = (blocks.fast_pool_context(tc.fast_pool_cin)
                if tc.fast_pool_cin else contextlib.nullcontext())
        with pool:
            return det.train_outputs(run, x, cfg)

    if tc.remat:
        if blocks._BRANCHES is not None:
            raise ValueError("a rematerialized forward runs twice; a "
                             "branch_context would record or impose its "
                             "choices twice")
        plain = fwd

        def fwd(x):
            return torch.utils.checkpoint.checkpoint(
                plain, x, use_reentrant=False,
                context_fn=_recompute_contexts)

    if cdt is None:
        return fwd

    def cast_fwd(x):
        return tuple(o.to(torch.float32) for o in fwd(x.to(cdt)))

    return cast_fwd


def loss_fn(model, cfg: DetectorConfig, tc: TrainConfig,
            images: torch.Tensor, gt_tensor):
    """One batch's loss on ``model`` (a float model with BN, on the
    images' device): ``images`` NHWC, uint8 RGB (normalized here by
    ``detector.normalize_u8``) or normalized float; ``gt_tensor`` [B, N,
    11] from ``train.targets.build_targets``. Returns (total,
    {'conf_loss', 'cls_loss', 'txtytwth_loss'}), float32 scalars that
    carry autograd; the BN running stats move in place, once also under
    ``tc.remat``. ``tc.compute_dtype`` runs the forward on copies of the
    parameters in that type, the loss in float32; ``tc.fast_pool_cin``
    the s2d pooled form of the conv + pool pairs with C_in up to it."""
    if images.dtype == torch.uint8:
        images = det.normalize_u8(images)
    conf, cls, txt, boxes_norm = _train_forward(model, cfg, tc)(images)
    conf_l, cls_l, box_l, total = yolo_loss(
        conf, cls, txt, boxes_norm, gt_tensor, cfg.num_classes,
        obj_loss_f=tc.obj_loss_f)
    return total, {"conf_loss": conf_l, "cls_loss": cls_l,
                   "txtytwth_loss": box_l}


def make_train_step(model, cfg: DetectorConfig, tc: TrainConfig, mesh=None):
    """-> (opt, step): ``opt`` the ``SGD`` (``opt.init(model)`` makes the
    state), ``step(opt_state, images, gt_tensor, lr) -> metrics`` one
    step on ``model`` in place: the gradients at the weights before it,
    then decay and update on the leaves after the forward's EMA, as the
    JAX package's step. The metrics ({'conf_loss', 'cls_loss',
    'txtytwth_loss', 'total_loss'}) stay on the device. ``mesh`` (data
    parallelism) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (data-parallel training) comes with parallel/, "
            "ROADMAP.md Queue 1 item 5")
    opt = SGD(tc)
    dev = next(model.parameters()).device

    def step(opt_state: SGDState, images, gt_tensor, lr: float):
        model.zero_grad(set_to_none=True)
        total, parts = loss_fn(model, cfg, tc,
                               torch.as_tensor(images).to(dev), gt_tensor)
        total.backward()
        opt.update(opt_state, lr)
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return opt, step


def device_resident_batches(cfg: DetectorConfig, dataset, batch: int,
                            device, seed: int = 0):
    """``dataset`` held whole on ``device`` (every sample transformed and
    its target rows built once), then its (images, targets) batches
    without end: ``len(dataset) // batch`` (at least 1) an epoch, each
    epoch a ``numpy.default_rng(seed).permutation`` and each step moving
    only a [batch] index vector, as the JAX package's
    ``train_device_resident`` draws them. Images keep the transform's
    type (float32, or uint8, normalized in the step)."""
    from yolo_tpu_torch.train.targets import build_targets

    imgs, tgts = [], []
    for i in range(len(dataset)):
        img, target, _, _ = dataset.pull_item(i)
        img = np.asarray(img)
        imgs.append(img if img.dtype == np.uint8 else
                    img.astype(np.float32))
        tgts.append(np.asarray(target).reshape(-1, 5))
    X = torch.as_tensor(np.stack(imgs)).to(device)
    G = torch.as_tensor(np.asarray(build_targets(cfg, tgts),
                                   np.float32)).to(device)
    n = int(X.shape[0])
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for it in range(max(1, n // batch)):
            idx = torch.as_tensor(order[it * batch:(it + 1) * batch]).to(
                device)
            yield X[idx], G[idx]


def train_device_resident(model, cfg: DetectorConfig, tc: TrainConfig,
                          dataset, batch: int, seed: int = 0,
                          verbose: bool = True):
    """Train ``model`` (a float model with BN, or a ``detector.Detector``)
    in place on a small ``dataset`` held whole on its device, on
    ``device_resident_batches``. The loss is read back every 10th epoch
    (printed with ``verbose``). Returns (model, last step's metrics as
    floats)."""
    model = getattr(model, "model", model)
    dev = next(model.parameters()).device
    opt, step = make_train_step(model, cfg, tc)
    opt_state = opt.init(model)
    spe = max(1, len(dataset) // batch)
    batches = device_resident_batches(cfg, dataset, batch, dev, seed)
    t0 = time.time()
    metrics = {}
    for epoch in range(tc.max_epoch):
        for it in range(spe):
            images, targets = next(batches)
            metrics = step(opt_state, images, targets,
                           lr_at(tc, epoch, it, spe))
        if verbose and (epoch + 1) % 10 == 0:
            print(f"epoch {epoch + 1}: loss="
                  f"{float(metrics['total_loss']):.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return model, {k: float(v) for k, v in metrics.items()}
