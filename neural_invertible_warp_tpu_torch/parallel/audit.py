"""The ray-sharded train step and render across processes, one per rank (the
port's counterpart of tools/multichip_audit.py --invariance).

``run(jobs, world_size, backend, device)`` starts ``world_size`` processes
with ``torch.multiprocessing``'s spawn method and a ``file://`` rendezvous
in a temporary directory (a file store, so that several runs on one host
need no free port). Each process builds every job's system from the arrays
and weights the job carries, runs its steps under a ``parallel.mesh`` group
and renders its views, and returns per rank: the global metrics of each
step, the summed gradients after the chosen steps, the parameters and aux
state at the end, the rendered views, the seconds per step and the kernel
launches it made. ``run_job(job, device)`` runs one job in this process,
without a group (the one-process reference) or under a given one.

A job is a dict of plain data (it is pickled to the workers):

    options   the resolved options, a plain dict (``opt.to_plain()``);
    train, test   dicts of numpy arrays for ``attach_data``;
    seed      the ``init_state`` seed (default 0);
    state_dict, aux, step   optional: weights (numpy, by parameter name),
              aux entries and the step to start from, set after init_state;
    steps     the number of train steps;
    draws     optional: one dict per step of ``train_step``'s injected draws
              (``ray_u``, ``depth_rand``, ``noise_rand`` as numpy), or None
              for the generator's (seed, step) draws;
    grads_at  the steps after which the gradients are kept (default [0]);
    render    indices of test views to render at the end (default []);
    float64   optional: run in float64 (arrays, weights, aux and draws), an
              evaluation to measure fp32 results against (CPU only).

On N GPUs, one rank per GPU (a CUDA ``device``, the default: rank r on
GPU r modulo the count), with ``backend="nccl"``; for several ranks on one
GPU, or on the CPU (``device="cpu"``), with ``gloo``. A worker that fails makes ``run`` raise, after the
other workers are stopped.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch

from . import mesh


def _launch_counts():
    from ..ops.cuda import fused_inn, fused_pe
    return {"k2": fused_pe.fused_render_rays_pe_train.launches,
            "k3": fused_pe.fused_render_rays_pe.launches,
            "k4": fused_pe.fused_render_rays_pe.backward_launches,
            "k6_fwd": fused_inn.fused_deform_forward.launches,
            "k6_bwd": fused_inn.fused_deform_forward.backward_launches}


def _synced_time(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def _tensor(x, job, device):
    """``x`` on ``device`` (a copy), float64 in a float64 job."""
    t = torch.as_tensor(np.array(x), device=device)
    return t.double() if job.get("float64") and t.is_floating_point() else t


def _to_device(draws, job, device):
    if not draws:
        return {}
    return {k: None if v is None else
            [_tensor(x, job, device) for x in v] if isinstance(v, (list, tuple)) else
            _tensor(v, job, device) for k, v in draws.items()}


def build_system(job, device):
    """The job's system on ``device``: built from its options and arrays,
    ``init_state(seed)``, then its weights, aux entries and step if given;
    for a float64 job, its weights, data and aux then made float64."""
    from ..dotdict import DotDict
    from ..models import get_system_class
    opt = DotDict(copy.deepcopy(job["options"]))
    system = get_system_class(opt.model)(opt, device)
    system.attach_data(job["train"], job["test"])
    system.init_state(job.get("seed", 0))
    if job.get("state_dict") is not None:
        system.graph.load_state_dict({k: torch.as_tensor(np.array(v))
                                      for k, v in job["state_dict"].items()})
    for k, v in (job.get("aux") or {}).items():
        system.aux[k] = torch.as_tensor(np.array(v), device=system.device)
    if job.get("float64"):
        system.graph.double()
        for split in (system.train_data, system.test_data, system.aux):
            for k, v in split.items():
                if v.is_floating_point():
                    split[k] = v.double()
    system.step = int(job.get("step", 0))
    return system


def run_job(job, device, group=None):
    """Run one job in this process under ``group`` (none: the one-process
    step). Returns dict(metrics, grads, params, aux, renders, step_seconds,
    render_seconds, launches, device)."""
    device = torch.device(device)
    system = build_system(job, device)
    draws = job.get("draws") or [None] * job["steps"]
    grads_at = set(job.get("grads_at", [0]))
    metrics, grads, seconds = [], {}, []
    before = _launch_counts()
    with mesh.use_group(group) if group is not None else contextlib.nullcontext():
        for s in range(job["steps"]):
            t0 = _synced_time(device)
            m = system.train_step(**_to_device(draws[s], job, device))
            seconds.append(_synced_time(device) - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            if s in grads_at:
                grads[s] = {name: p.grad.detach().cpu().numpy()
                            for name, p in system.graph.named_parameters()
                            if p.grad is not None}
        after_train = _launch_counts()
        renders, render_seconds = [], []
        for i in job.get("render", []):
            t0 = _synced_time(device)
            out = system.render_image(system.test_data["pose"][i:i + 1],
                                      system.test_data["intr"][i:i + 1])
            render_seconds.append(_synced_time(device) - t0)
            renders.append({k: v.cpu().numpy() for k, v in out.items()})
        after_render = _launch_counts()
    launches = {"train_" + k: after_train[k] - before[k] for k in before}
    launches.update({"render_" + k: after_render[k] - after_train[k] for k in before})
    return dict(metrics=metrics, grads=grads, renders=renders, step_seconds=seconds,
                render_seconds=render_seconds, launches=launches,
                params={k: v.detach().cpu().numpy() for k, v in system.graph.state_dict().items()},
                aux={k: v.detach().cpu().numpy() for k, v in system.aux.items()},
                device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"))


def worker(rank, world_size, backend, init_file, jobs, out_dir, device, timeout):
    """One rank: join the group, run every job under it, write the results
    to ``<out_dir>/rank<rank>.pkl``."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="file://" + init_file, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        group = mesh.make_group()
        results = [run_job(job, dev, group) for job in jobs]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "rank{}.pkl".format(rank)), "wb") as f:
        pickle.dump(results, f)


def run(jobs, world_size, backend, device="cuda", timeout=600):
    """Run ``jobs`` in ``world_size`` spawned ranks on ``device`` (the
    card unless the caller names the CPU). Returns, per rank, the list of
    ``run_job`` results. ``timeout`` (seconds) bounds each collective and
    the whole run: past it the ranks are stopped and TimeoutError is
    raised."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run the ranks on the CPU with device='cpu'")
    with tempfile.TemporaryDirectory(prefix="niw_audit_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        context = mp.start_processes(worker, args=(world_size, backend, init_file, jobs, tmp,
                                                   device, timeout),
                                     nprocs=world_size, join=False, start_method="spawn")
        deadline = time.time() + timeout
        while not context.join(timeout=5):     # raises where a rank failed
            if time.time() > deadline:
                for process in context.processes:
                    process.kill()
                raise TimeoutError("the ranks did not finish in {} s".format(timeout))
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, "rank{}.pkl".format(rank)), "rb") as f:
                out.append(pickle.load(f))
    return out


def max_rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
