"""Multi-host initialization for GPU clusters (SURVEY section 7 stage 6).

The reference is single-process (OpenMP threads over one address space,
main.cpp:8-10); scaling beyond one host means one JAX process per host
cooperating through `jax.distributed`.  After `init()`, every host sees
the global device set and the existing GSPMD path (parallel.api) runs
unchanged over a mesh spanning all hosts' GPUs: leaf-level fields and
caches stay sharded over ("x", "y"), and halo traffic runs as NCCL
collectives -- over NVLink between the cards of one host and over the
cluster network across hosts -- all chosen by XLA from the same program
that runs on one host.

Driven from the CLI: `python -m aniso_tpu run data.cfg --distributed
[--coordinator host:port --num-processes N --process-id K]`, or with no
arguments under Slurm or OpenMPI, whose environment
`jax.distributed.initialize` reads on its own.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from ..utils.logging import log


def init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed across hosts.

    With no arguments, relies on jax.distributed's cluster auto-detection
    (Slurm, OpenMPI); explicit args override it elsewhere -- a machine
    with no cluster manager needs all three.  Values may also come from ANISO_COORDINATOR,
    ANISO_NUM_PROCESSES, ANISO_PROCESS_ID.
    """
    coordinator = coordinator or os.environ.get("ANISO_COORDINATOR")
    if num_processes is None and "ANISO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ANISO_NUM_PROCESSES"])
    if process_id is None and "ANISO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ANISO_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        f"jax.distributed up: process {jax.process_index()}/"
        f"{jax.process_count()}, {jax.local_device_count()} local / "
        f"{jax.device_count()} global devices"
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1
