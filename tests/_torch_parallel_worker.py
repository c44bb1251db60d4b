"""One rank of the port's multi-process CPU tests (not collected).

Run as ``python -m tests._torch_parallel_worker JOB RANK WORLD DIR``: the
rank joins a gloo group through a ``file://`` store in DIR, reads the global
batches and weights the parent test wrote to ``DIR/inputs.npz``, runs JOB
("dp": 2 ranks, tests/test_torch_parallel.py; "spatial": 4 ranks,
tests/test_torch_spatial.py) and writes what it computed to
``DIR/rank{RANK}.npz``. It imports torch and the port, never jax.
:func:`launch` starts the ranks from a test.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch

OUT: Dict[str, np.ndarray] = {}


def launch(job: str, world: int, tmp, inputs: Dict[str, np.ndarray], timeout: int = 300):
    """Run ``job`` on ``world`` gloo ranks (one process each, launched from
    the repository's root) with ``inputs``; every rank's results, by rank."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "tests._torch_parallel_worker", job,
                               str(r), str(world), str(tmp)], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def put(key: str, value) -> None:
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if hasattr(value, "full_tensor"):  # an FSDP parameter (DTensor)
            value = value.full_tensor()
        value = value.cpu().numpy().copy()  # not a view of a tensor that moves on
    OUT[key] = np.asarray(value)


def state_dict(inputs, prefix: str, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    n = len(prefix) + 1
    return {k[n:]: torch.from_numpy(inputs[k]).to(dtype) for k in inputs.files
            if k.startswith(prefix + "/")}


def put_params(prefix: str, module: torch.nn.Module) -> None:
    for name, p in module.named_parameters():
        put(f"{prefix}/{name}", p)


def convlstm(inputs, prefix: str, **kw):
    from satflow_tpu_torch.core.registry import create_model

    model = create_model("encoderdecoderconvlstm", **{**dict(
        input_channels=4, out_channels=4, forecast_steps=2, hidden_dim=8, remat=False), **kw})
    model.module.load_state_dict(state_dict(inputs, prefix))
    return model


def batch_of(inputs, name: str):
    return (inputs[f"{name}_x"], inputs[f"{name}_y"])


# -- job "dp": 2 ranks ---------------------------------------------------------------


def placement(inputs) -> None:
    """make_mesh, shard_batch (data, spatial, indivisible), the DTensor
    placements."""
    from torch.distributed.tensor import distribute_tensor

    from satflow_tpu_torch.parallel.mesh import (
        batch_sharding,
        get_mesh,
        make_mesh,
        mesh_scope,
        replicated_sharding,
        shard_batch,
    )

    mesh = get_mesh()
    put("mesh_shape", list(mesh.shape))
    put("mesh_names", np.array(mesh.mesh_dim_names))
    x = inputs["mesh_x"]
    sx = shard_batch({"sat_data": x, "nwp": inputs["mesh_nwp"], "n": 3})
    put("mesh_block", sx["sat_data"])
    put("mesh_nwp_block", sx["nwp"])
    put("mesh_passthrough", sx["n"] == 3)
    put("mesh_dtensor_equal", torch.equal(
        distribute_tensor(torch.from_numpy(x), mesh, batch_sharding(mesh)).to_local(),
        sx["sat_data"]))
    put("mesh_replicated_equal", torch.equal(
        distribute_tensor(torch.from_numpy(x), mesh, replicated_sharding(mesh)).to_local(),
        torch.from_numpy(x)))
    put("mesh_odd_batch", list(shard_batch(x[:3]).shape))
    spatial = make_mesh([1, 2])
    with mesh_scope(spatial, spatial_axis="model"):
        sp = shard_batch({"sat_data": x, "nwp": inputs["mesh_nwp"]})
        put("mesh_spatial_block", sp["sat_data"])
        put("mesh_spatial_nwp", sp["nwp"])
        put("mesh_spatial_bare", shard_batch(x))
        try:
            shard_batch({"sat_data": x[:, :, :-1]})
            put("mesh_odd_h_raises", "")
        except ValueError as e:
            put("mesh_odd_h_raises", str(e))
    put("mesh_scope_restored", get_mesh() is mesh)
    put("mesh_outside_scope", shard_batch(x, spatial))  # plain DP placement


def dp_step(inputs) -> None:
    """One train step of the ConvLSTM on this rank's block: loss, metrics,
    the updated weights (every rank's are held equal by the parent)."""
    from satflow_tpu_torch.parallel.mesh import shard_batch
    from satflow_tpu_torch.train.state import TrainState
    from satflow_tpu_torch.train.steps import make_train_step

    model = convlstm(inputs, "cl")
    state = TrainState(model, model.make_optimizer())
    metrics = make_train_step(model)(state, shard_batch(batch_of(inputs, "cl")))
    for k in ("loss", "grad_norm", "frame_loss", "finite"):
        put(f"dp_{k}", metrics[k])
    put_params("dp", model.module)


def zero_fit_and_resume(inputs, tmp: str) -> None:
    """Two steps under ZeRO, a checkpoint, resumes into a plain and into a
    ZeRO state, a third step on both paths; a ZeRO LAMB under a schedule
    against a plain one; Trainer(zero_sharding=True)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from satflow_tpu_torch.parallel.mesh import shard_batch
    from satflow_tpu_torch.parallel.zero import apply_zero_sharding
    from satflow_tpu_torch.train.checkpoint import resume_state, save_checkpoint
    from satflow_tpu_torch.train.state import TrainState
    from satflow_tpu_torch.train.steps import make_train_step

    def zero_state(model):
        return apply_zero_sharding(TrainState(model, model.make_optimizer()))

    model = convlstm(inputs, "cl")
    state = zero_state(model)
    step = make_train_step(model)
    batches = [shard_batch(batch_of(inputs, name)) for name in ("cl", "cl2", "cl3")]
    for i in range(2):
        put(f"zero_loss{i}", step(state, batches[i])["loss"])
    put_params("zero2", model.module)
    put("zero_local_moments", len(state.optimizer.optim.state))
    put("zero_all_params", len(state.params()))
    ck = os.path.join(tmp, "zero_ck")
    save_checkpoint(ck, state, model)
    torch.distributed.barrier()
    step(state, batches[2])
    put_params("zero3", model.module)

    plain_model = convlstm(inputs, "cl")
    plain = TrainState(plain_model, plain_model.make_optimizer())
    resume_state(plain, ck)
    moments = plain.optimizer.state_dict()["state"]
    for i, p in enumerate(plain.params()):
        put(f"resumed_plain_m/{i}", moments[i]["exp_avg"])
        put(f"resumed_plain_v/{i}", moments[i]["exp_avg_sq"])
    resumed_model = convlstm(inputs, "cl")
    resumed = zero_state(resumed_model)
    _, gstep = resume_state(resumed, ck)
    put("resumed_step", gstep)
    put("resumed_zero_is_zero", isinstance(resumed.optimizer, ZeroRedundancyOptimizer))
    make_train_step(resumed_model)(resumed, batches[2])
    put_params("resumed3", resumed_model.module)
    # the consolidated moments after two steps, read on rank 0
    state2 = zero_state(convlstm(inputs, "cl"))
    resume_state(state2, ck)
    full = state2.state_dict()["optimizer"]
    if full is not None:
        for i in range(len(state2.params())):
            put(f"resumed_zero_m/{i}", full["state"][i]["exp_avg"])

    # LAMB under warmup_cosine: rebuilt from its class, the schedule's hook kept
    from satflow_tpu_torch.train.lamb import Lamb
    from satflow_tpu_torch.train.schedules import scheduled, warmup_cosine

    def lamb_state(seed):
        net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
        net.load_state_dict({k: torch.from_numpy(v) for k, v in zip(
            net.state_dict(), (inputs["lamb_w0"], inputs["lamb_b0"], inputs["lamb_w1"],
                               inputs["lamb_b1"]))})
        opt = scheduled(Lamb(net.parameters(), lr=1e-2), warmup_cosine(1e-2, 4, 10))
        return net, TrainState(net, opt)

    for name, sharded in (("lamb_plain", False), ("lamb_zero", True)):
        net, st = lamb_state(0)
        if sharded:
            apply_zero_sharding(st)
        for i in range(3):
            out = net(torch.from_numpy(inputs["lamb_x"][i]))
            out.square().mean().backward()
            st.apply_gradients()
        put_params(name, net)
        put(f"{name}_lr", st.optimizer.param_groups[0]["lr"])

    fit_model = convlstm(inputs, "cl")
    from satflow_tpu_torch.train import Trainer

    trainer = Trainer(fast_dev_run=True, zero_sharding=True, device="cpu", seed=0)
    metrics = trainer.fit(fit_model, datamodule(inputs))
    put("zero_fit_loss", metrics["train/loss"])
    put("zero_fit_is_zero", isinstance(trainer.state.optimizer, ZeroRedundancyOptimizer))


def datamodule(inputs, **kw):
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule

    return SatFlowDataModule(**{**dict(
        fake_data=True, num_workers=0, n_train_data=2, n_val_data=1, history_minutes=10,
        forecast_minutes=10, fake_kwargs=dict(batch_size=4, width=16, height=16,
                                              number_sat_channels=4)), **kw})


def fsdp_step(inputs, tmp: str) -> None:
    """apply_zero_sharding(shard_params=True): FSDP2 over the data axis; its
    checkpoint (full tensors) into a plain and into an FSDP state."""
    from satflow_tpu_torch.parallel.mesh import shard_batch
    from satflow_tpu_torch.parallel.zero import apply_zero_sharding
    from satflow_tpu_torch.train.checkpoint import resume_state, save_checkpoint
    from satflow_tpu_torch.train.state import TrainState
    from satflow_tpu_torch.train.steps import make_train_step

    def fsdp_state(model):
        return apply_zero_sharding(TrainState(model, model.make_optimizer()), shard_params=True)

    model = convlstm(inputs, "cl")
    state = fsdp_state(model)
    put("fsdp_local_numel", sum(p.to_local().numel() for p in model.module.parameters()))
    batches = [shard_batch(batch_of(inputs, name)) for name in ("cl", "cl2")]
    metrics = make_train_step(model)(state, batches[0])
    put("fsdp_loss", metrics["loss"])
    put_params("fsdp", model.module)
    ck = os.path.join(tmp, "fsdp_ck")
    save_checkpoint(ck, state, model)
    torch.distributed.barrier()
    make_train_step(model)(state, batches[1])
    put_params("fsdp2", model.module)
    plain_model = convlstm(inputs, "cl")
    resume_state(TrainState(plain_model, plain_model.make_optimizer()), ck)
    put_params("fsdp_resumed_plain", plain_model.module)
    resumed_model = convlstm(inputs, "cl")
    resumed = fsdp_state(resumed_model)
    resume_state(resumed, ck)
    make_train_step(resumed_model)(resumed, batches[1])
    put_params("fsdp_resumed2", resumed_model.module)


def fcn_model(inputs):
    import satflow_tpu_torch.models.segmentation as seg
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.nn.resnet import ResNetBackbone

    seg.ResNetBackbone = lambda stages, **kw: ResNetBackbone((1, 1, 1, 1), width=4, **kw)
    model = create_model("fcn", input_channels=3, forecast_steps=2)
    model.module.load_state_dict(state_dict(inputs, "fcn"))
    return model


def batchnorm(inputs) -> None:
    """Train-mode statistics of fcn on this rank's block (float32), and one
    backward's gradients in float64."""
    from satflow_tpu_torch.parallel.mesh import shard_batch
    from satflow_tpu_torch.train.state import TrainState

    model = fcn_model(inputs).train()
    x, _ = shard_batch(batch_of(inputs, "fcn"))
    with torch.no_grad():
        model(x)
    params = dict(model.module.named_parameters())
    for k, v in model.module.state_dict().items():
        if k not in params:
            put(f"bn_stats/{k}", v)
    model = fcn_model(inputs).double().train()
    batch = tuple(t.double() for t in shard_batch(batch_of(inputs, "fcn")))
    state = TrainState(model, model.make_optimizer())
    loss, _ = model.loss(batch)
    loss.backward()
    state.reduce_gradients()
    for name, p in model.module.named_parameters():
        put(f"bn_grad/{name}", p.grad)


def gan_round(inputs) -> None:
    """One CloudGAN round (float64) on this rank's block, plain and under
    ZeRO: both networks after it and the round's metrics."""
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.parallel.mesh import shard_batch
    from satflow_tpu_torch.parallel.zero import apply_zero_sharding
    from satflow_tpu_torch.train.state import GANTrainState
    from satflow_tpu_torch.train.steps import make_gan_train_step

    for name, zero in (("gan", False), ("gan_zero", True)):
        model = create_model("cloudgan", forecast_steps=2, input_channels=2,
                             channels_per_timestep=2, num_filters=4, features_start=4,
                             unet_depth=2)
        model.materialize(tuple(torch.from_numpy(a[:1]) for a in batch_of(inputs, "gan")))
        model.load_state_dict(state_dict(inputs, "gan"))
        model.double()
        state = GANTrainState.create(model, *model.make_optimizers(), torch.Generator())
        if zero:
            apply_zero_sharding(state)
        batch = tuple(t.double() for t in shard_batch(batch_of(inputs, "gan")))
        metrics = make_gan_train_step(model)(state, batch)
        put(f"{name}_d_loss", metrics["d_loss"])
        put(f"{name}_g_loss", metrics["g_loss"])
        for k, v in model.state_dict().items():
            put(f"{name}/{k}", v)


def dp_fit(inputs) -> None:
    """Trainer.fit, 2 steps, the data module's loaders cutting each rank's
    block (float64 compute)."""
    from satflow_tpu_torch.train import Trainer

    model = convlstm(inputs, "cl", dtype=torch.float64).double()
    trainer = Trainer(max_steps=2, log_every_n_steps=1, device="cpu", seed=0)
    trainer.fit(model, datamodule(inputs))
    put("fit_losses", [e["train/loss"] for e in trainer.history.history if "train/loss" in e])
    put("fit_val_loss", trainer.callback_metrics["val/loss"])
    put("fit_block_shape", list(trainer.last_batch[0]["sat_data"].shape))
    put_params("fit", model.module)


def job_dp(inputs, tmp: str) -> None:
    placement(inputs)
    dp_step(inputs)
    zero_fit_and_resume(inputs, tmp)
    fsdp_step(inputs, tmp)
    batchnorm(inputs)
    gan_round(inputs)
    dp_fit(inputs)


# -- job "spatial": 4 ranks --------------------------------------------------------


def core(inputs, prefix: str, **kw):
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    c = ConvLSTMCore(hidden_dim=8, in_channels=4, out_channels=4, forecast_steps=4, **kw)
    c.load_state_dict(state_dict(inputs, prefix))
    return c


def job_spatial(inputs, tmp: str) -> None:  # noqa: ARG001 - the same signature as job_dp
    import torch.distributed as dist

    from satflow_tpu_torch.parallel.mesh import make_mesh
    from satflow_tpu_torch.parallel.spatial import convlstm_spatial_forward

    x = torch.from_numpy(inputs["core_x"])
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(list(shape))
        tag = f"{shape[0]}x{shape[1]}"
        y = convlstm_spatial_forward(core(inputs, "core"), x, 4, mesh, axis="model")
        put(f"sp_{tag}", y)
        put(f"sp_{tag}_coords", [mesh.get_local_rank("data"), mesh.get_local_rank("model")])
    mesh = make_mesh([1, 4])
    put("sp_chunked", convlstm_spatial_forward(core(inputs, "chunk", remat=True, remat_chunk=2),
                                               x, 4, mesh, axis="model"))
    try:
        convlstm_spatial_forward(core(inputs, "core"), x[:, :, :30], 4, mesh)
        put("sp_odd_h", "")
    except ValueError as e:
        put("sp_odd_h", str(e))

    # gradients of the global sum((y - 0.5)^2) and one Adam step from them
    c = core(inputs, "core")
    y = convlstm_spatial_forward(c, x, 4, mesh, axis="model")
    loss = torch.sum((y - 0.5) ** 2)
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total)
    put("sp_loss", total)
    for p in c.parameters():
        dist.all_reduce(p.grad)
    for name, p in c.named_parameters():
        put(f"sp_grad/{name}", p.grad)
    torch.optim.Adam(c.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8).step()
    put_params("sp_adam", c)

    # Trainer(spatial="2x2"): 2 steps, float64 compute
    from satflow_tpu_torch.parallel.mesh import get_mesh
    from satflow_tpu_torch.train import Trainer

    mesh_before = get_mesh()
    model = convlstm(inputs, "fit", out_channels=1, dtype=torch.float64).double()
    trainer = Trainer(max_steps=2, spatial="2x2", log_every_n_steps=1, device="cpu", seed=0)
    trainer.fit(model, datamodule(inputs))
    put("fit_mesh_restored", get_mesh() is mesh_before)
    put("fit_block_shape", list(trainer.last_batch[0]["sat_data"].shape))
    put("fit_losses", [e["train/loss"] for e in trainer.history.history if "train/loss" in e])
    put("fit_val_loss", trainer.callback_metrics["val/loss"])
    put_params("fit", model.module)


def main() -> None:
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from satflow_tpu_torch.parallel.distributed import maybe_initialize_distributed

    store = os.path.join(tmp, "store")
    assert maybe_initialize_distributed(f"file://{store}", world, rank, backend="cpu")
    inputs = np.load(os.path.join(tmp, "inputs.npz"))
    {"dp": job_dp, "spatial": job_spatial}[job](inputs, tmp)
    put("imports_jax", any(m.split(".")[0] in ("jax", "flax", "optax") or m == "satflow_tpu"
                           or m.startswith("satflow_tpu.") for m in sys.modules))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **OUT)
    from satflow_tpu_torch.parallel.distributed import shutdown_distributed

    shutdown_distributed()


if __name__ == "__main__":
    main()
