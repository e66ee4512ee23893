"""A toy replica process for the port's fleet tests (not a test module).

Runs one real :class:`~sheeprl_tpu_torch.serve.server.PolicyServer` (socket
front end, supervised scheduler, optional checkpoint watcher, the SIGTERM
drain, exit 0) around a toy policy on the CPU, so a fleet drill pays a torch
import per replica instead of a checkpoint load. Imports no JAX.

Usage::

    python tests/torch_fleet_replica_main.py --port 0 [--stateful] [--watch DIR]
        [--watch-poll 0.05] [--buckets 1,4] [--max-wait-ms 1] [--request-timeout 30]

Prints ``REPLICA_READY host:port`` once the socket is up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def build_policy(stateful: bool):
    from sheeprl_tpu_torch.ops import counter_uniform
    from sheeprl_tpu_torch.serve.policy import ServePolicy, StatefulServePolicy

    prepare = lambda obs, n: {"x": np.asarray(obs["x"], np.float32).reshape(n, 2)}  # noqa: E731
    if stateful:
        # action row = [count, w·obs]: a reset, a drop or a mixed-up session
        # shows in the actions themselves
        def step_fn(p, obs, state, greedy):
            count = state["count"][:, 0]
            y = (obs["x"] @ p["w"]).sum(-1)
            return torch.stack([count, y], dim=-1), {"count": state["count"] + 1.0}

        return StatefulServePolicy(
            name="toy_stateful",
            params={"w": torch.arange(4, dtype=torch.float32).reshape(2, 2)},
            obs_spec={"x": ((2,), np.float32)},
            action_dim=2,
            step_fn=step_fn,
            init_fn=lambda p, n: {"count": torch.zeros((n, 1), dtype=torch.float32)},
            prepare=prepare,
            params_from_state=lambda state: {"w": torch.as_tensor(np.asarray(state["agent"]["w"]), dtype=torch.float32)},
            device=torch.device("cpu"),
        )
    return ServePolicy(
        name="toy",
        params={"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        obs_spec={"x": ((2,), np.float32)},
        action_dim=3,
        greedy_fn=lambda p, obs: obs["x"] @ p["w"],
        sample_fn=lambda p, obs, noise: obs["x"] @ p["w"] + 1e-3 * noise,
        draw_fn=lambda seed, counter: torch.special.ndtri(counter_uniform(seed, counter, 0, 3)),
        prepare=prepare,
        params_from_state=lambda state: {"w": torch.as_tensor(np.asarray(state["agent"]["w"]), dtype=torch.float32)},
        device=torch.device("cpu"),
    )


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--stateful", action="store_true")
    parser.add_argument("--watch", default=None)
    parser.add_argument("--watch-poll", type=float, default=0.05)
    parser.add_argument("--buckets", default="1,4")
    parser.add_argument("--max-wait-ms", type=float, default=1.0)
    parser.add_argument("--request-timeout", type=float, default=30.0)
    args = parser.parse_args()
    torch.set_num_threads(1)

    from sheeprl_tpu_torch.serve.server import PolicyServer, install_drain_handlers

    buckets = [int(b) for b in args.buckets.split(",") if b.strip()]
    cfg = {
        "buckets": buckets,
        "host": args.host,
        "port": args.port,
        "max_wait_ms": args.max_wait_ms,
        "request_timeout_s": args.request_timeout,
        "watch_poll_s": args.watch_poll,
        "watch_publish_current": True,  # a respawned replica rejoins on the newest complete save
        "supervisor": {"backoff": 0.02},
    }
    if args.stateful:
        cfg["session"] = {"buckets": buckets, "ttl_s": 300.0, "max_sessions": 64}
    drain = threading.Event()
    restore = install_drain_handlers(drain)
    server = PolicyServer(build_policy(args.stateful), cfg, watch_dir=args.watch).start()
    host, port = server.address
    print(f"REPLICA_READY {host}:{port}", flush=True)
    try:
        while not drain.is_set():
            drain.wait(0.2)
    finally:
        server.stop()
        restore()
        print(json.dumps({**server.stats.snapshot(), **server.engine.stats()}), flush=True)
        if drain.is_set():
            print("serve: drained cleanly", flush=True)


if __name__ == "__main__":
    main()
