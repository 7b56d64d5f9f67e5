"""Process groups for the `shard` engine: one rank per TP shard, the
real-device counterpart of `launch/mesh.make_test_mesh`.

World rank `(p * dp + d) * tp + m` is pod rank p, data rank d and model
rank m, the reference's mesh layout (`make_test_mesh(dp, tp, pod)`
reshapes its devices to (pod, dp, tp); without a pod factor, rank
`d * tp + m`).  `init_tp` builds one model group per (pod, data) slot
(the ranks of one TP replica, over which the syncs reduce) and one data
group per (pod, model) pair (over which a sharded batch is gathered
back and a train step reduce-scatters).  With a pod factor > 1 it also
builds, for the train step's pod axis, one pod group per (data, model)
pair, one (pod, data) group per model rank and one (data, model) group
per pod.  The backend is named by the caller: "nccl" for ranks on CUDA
devices, "gloo" for the CPU (or for CUDA tensors staged through the
host).  Nothing tries one backend and then another.  A rank runs on
cuda:LOCAL_RANK unless the caller asks for the CPU (`device="cpu"`).

Launch one rank per GPU with torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc-per-node 2 serve.py      # serve.py:
        init_tp(2, 1, backend="nccl")
        llm = LLM.load("llama2-7b", tp=2, engine="shard")

or from one Python process with `spawn(fn, world, backend=, device=)`,
which starts `world` processes, initializes the default group in each
and calls `fn(rank, *args)`.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

BACKENDS = ("nccl", "gloo")
#: seconds a collective (and a group's creation) may wait for its peers
#: before it raises: a rank whose host decisions diverged fails the run
#: instead of hanging it
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class TPGroups:
    """This rank's place in the (pod, data, model) layout and its groups:
    the model and data groups, and for the train step's pod axis the pod
    group (ranks of this (data, model) pair), the (pod, data) group
    (ranks of this model rank) and the replica group (ranks of this pod,
    its (data, model) slots).  With a pod factor of 1 the pod group is
    None, the (pod, data) group the data group and the replica group the
    world."""

    tp: int
    dp: int
    rank: int
    world: int
    model_rank: int
    data_rank: int
    model_group: object
    data_group: object
    backend: str
    device: torch.device
    pod: int = 1
    pod_rank: int = 0
    pod_group: object = None
    pod_data_group: object = None
    replica_group: object = None


_GROUPS: Optional[TPGroups] = None


def current() -> Optional[TPGroups]:
    """The groups `init_tp` built in this process, or None."""
    return _GROUPS


def _from_env(name: str, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"init_tp: {name} is not set; launch the ranks "
                           "with torchrun or launch.dist.spawn, or pass it")
    return int(os.environ[name])


def rank_device(backend: str, device, local_rank: int) -> torch.device:
    """`device` as given ("cuda" names the rank's own card); by default
    cuda:LOCAL_RANK under either backend (gloo stages CUDA tensors
    through the host).  Without a CUDA device it raises unless
    `device="cpu"` is asked for: there is no silent CPU rank."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass "
                               "device='cpu' (with backend 'gloo') to run "
                               "it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
    return dev


def init_tp(tp: int, dp: int = 1, pod: int = 0, *, backend: str,
            device=None, rank: Optional[int] = None,
            world_size: Optional[int] = None,
            local_rank: Optional[int] = None,
            timeout_s: float = DEFAULT_TIMEOUT_S) -> TPGroups:
    """Initialize the default group (unless it is) and this rank's
    groups.  RANK, WORLD_SIZE and LOCAL_RANK come from the environment
    (torchrun's) unless given; the world must be pod x tp x dp (`pod` 0:
    no pod axis, as 1).  `device` as in `rank_device`: cuda:LOCAL_RANK
    unless "cpu" is asked for."""
    global _GROUPS
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    npod = max(int(pod), 1)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if dist.get_backend() != backend:
            raise ValueError(f"the default group runs {dist.get_backend()!r}"
                             f", not {backend!r}")
    else:
        rank = _from_env("RANK", rank)
        world = _from_env("WORLD_SIZE", world_size)
    if world != npod * tp * dp:
        raise ValueError(f"world size {world} is not "
                         + (f"pod {pod} x " if pod else "")
                         + f"tp {tp} x dp {dp}")
    local = _from_env("LOCAL_RANK", local_rank)
    dev = rank_device(backend, device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)

    def at(p, d, m):
        return (p * dp + d) * tp + m

    def mine(rank_lists):
        """Create a group of each list, in order (every rank creates every
        group, in the same order); return the one holding this rank."""
        out = None
        for ranks in rank_lists:
            g = dist.new_group(ranks, timeout=timeout, backend=backend)
            if rank in ranks:
                out = g
        return out

    P, D, M = range(npod), range(dp), range(tp)
    model = mine([[at(p, d, m) for m in M] for p in P for d in D])
    data = mine([[at(p, d, m) for d in D] for p in P for m in M])
    pod_g, pod_data, replica = None, data, dist.group.WORLD
    if npod > 1:
        pod_g = mine([[at(p, d, m) for p in P] for d in D for m in M])
        pod_data = mine([[at(p, d, m) for p in P for d in D] for m in M])
        replica = mine([[at(p, d, m) for d in D for m in M] for p in P])
    _GROUPS = TPGroups(tp=tp, dp=dp, rank=rank, world=world,
                       model_rank=rank % tp, data_rank=rank // tp % dp,
                       model_group=model, data_group=data, backend=backend,
                       device=dev, pod=npod, pod_rank=rank // (tp * dp),
                       pod_group=pod_g, pod_data_group=pod_data,
                       replica_group=replica)
    return _GROUPS


def shutdown() -> None:
    """Destroy the process groups (every rank calls it)."""
    global _GROUPS
    import torch.distributed as dist

    _GROUPS = None
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# spawn: `world` ranks from one Python process (tests, chip_smoke)
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, backend, device, port, args, timeout_s,
               out):
    import torch.distributed as dist

    try:
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, world + 1, is_master=False,
                              timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *, backend: str, device=None, args=(),
          deadline_s: float = 600.0, timeout_s: float = 120.0) -> list:
    """Run `fn(rank, *args)` in `world` new processes (the spawn start
    method: nothing of CUDA is forked) with the default group initialized
    in each, and return their results in rank order.  `device` as in
    `rank_device` ("cuda" gives rank r the card r; "cuda:0" puts every
    rank on card 0).  The parent holds the rendezvous store on a port the
    OS picks (port 0), so concurrent spawns never collide.  A rank that
    raises, or a run past `deadline_s`, ends every rank and raises here;
    `timeout_s` bounds each collective's wait."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    rank_device(backend, device, 0)      # no CUDA, no default: raise here
    store = dist.TCPStore("127.0.0.1", 0, world + 1, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, device, store.port,
                               args, timeout_s, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failure = {}, None
    end = time.monotonic() + deadline_s
    try:
        while len(results) < world and failure is None:
            left = end - time.monotonic()
            if left <= 0:
                failure = (f"spawn: {world - len(results)} of {world} ranks "
                           f"still running after {deadline_s:.0f} s")
                break
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and out.empty():
                    time.sleep(0.5)   # a result may still be in flight
                    if out.empty():
                        failure = (f"spawn: rank {dead[0]} exited with "
                                   f"code {procs[dead[0]].exitcode} and no "
                                   "result")
                continue
            if ok:
                results[rank] = val
            else:
                failure = f"spawn: rank {rank} raised:\n{val}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=max(5.0, end - time.monotonic())
                   if failure is None else 5.0)
            if p.is_alive():
                p.kill()
                p.join()
        del store
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]
