"""Pod-level serving orchestrator: one fleet_serve PROCESS per card
(docs/DEPLOY.md's topology — independent streams want no cross-card
traffic and no shared failure domain), plus one aggregated pod view.

Worker k sees only card k (CUDA_VISIBLE_DEVICES is narrowed to the k-th
visible card), since a JAX process reserves most of a card's memory and a
second process on the same card would fail. Each worker also gets its own
snapshot file and a private status port; the parent runs no JAX work.
It polls every worker's /state.json and serves the merged view at /pod.json
(plus plain-text at /). Workers that exit are reported, and on shutdown
every worker receives SIGINT so --snapshot-out checkpoints land.

Usage (one worker per card of a 4-card host):
  python tools/serve_pod.py --workers 4 -i cap.u8 --shared-input \\
      --streams-per-worker 16 --subchannels 0:48:EEP3A,48:48:EEP3A \\
      --frames-per-step 16 --port 8900 [--max-rounds N]
(add --backend cpu for a demo without cards).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from dab_radio_tpu.utils.backend import add_backend_flag  # noqa: E402


def aggregate_pod(worker_states):
    """Merge parsed /state.json dicts (fleet_serve._status_blob shape:
    {"streams": [per-stream rows], "totals": {counters}}) into the pod
    counter view. Tolerates missing/None entries (worker not up yet)."""
    totals = [(s.get("totals") or {}) for s in worker_states
              if isinstance(s, dict)]
    return {
        "rounds": sum(t.get("rounds", 0) for t in totals),
        "access_units": sum(t.get("access_units", 0) for t in totals),
        "streams": sum(t.get("streams", 0) for t in totals),
    }


def worker_command(args, k: int, environ=None):
    """(argv, env) of worker k: a fleet_serve process pinned to the k-th
    visible card, with its own status port and snapshot file."""
    environ = os.environ if environ is None else environ
    cmd = [sys.executable, "-m", "dab_radio_tpu.apps.fleet_serve",
           "-i", args.input, "--shared-input",
           "--streams", str(args.streams_per_worker),
           "--frames-per-step", str(args.frames_per_step),
           "--port", str(args.base_port + k),
           "--backend", args.backend]
    if args.subchannels:
        cmd += ["--subchannels", args.subchannels]
    else:
        cmd += ["--discover"]
    if args.max_rounds:
        cmd += ["--max-rounds", str(args.max_rounds)]
    if args.snapshot_dir:
        cmd += ["--snapshot-out",
                os.path.join(args.snapshot_dir, f"worker{k}.snap")]
    visible = environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(i)
                                               for i in range(args.workers)]
    if k >= len(cards):
        raise ValueError(f"worker {k} has no card: CUDA_VISIBLE_DEVICES="
                         f"{visible!r} lists {len(cards)}")
    env = dict(environ, CUDA_VISIBLE_DEVICES=cards[k])
    return cmd, env


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("-i", "--input", required=True,
                    help="shared capture (every worker decodes its own "
                         "streams from it)")
    ap.add_argument("--shared-input", action="store_true", default=True)
    ap.add_argument("--streams-per-worker", type=int, default=2)
    ap.add_argument("--subchannels", default=None)
    ap.add_argument("--discover", action="store_true")
    ap.add_argument("--frames-per-step", type=int, default=8)
    ap.add_argument("--max-rounds", type=int, default=0)
    ap.add_argument("--port", type=int, default=0,
                    help="aggregated /pod.json on 127.0.0.1:PORT")
    ap.add_argument("--base-port", type=int, default=8950,
                    help="workers get base-port+k status ports")
    ap.add_argument("--snapshot-dir", default=None)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    if args.snapshot_dir:
        os.makedirs(args.snapshot_dir, exist_ok=True)

    procs = []
    for k in range(args.workers):
        cmd, env = worker_command(args, k)
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        procs.append(p)
        print(f"# worker {k}: pid={p.pid} status port "
              f"{args.base_port + k}", file=sys.stderr, flush=True)

    last_state = {}

    def pod_state():
        out = {"workers": []}
        for k, p in enumerate(procs):
            w = {"worker": k, "pid": p.pid,
                 "alive": p.poll() is None, "rc": p.poll()}
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{args.base_port + k}/state.json",
                        timeout=2) as r:
                    last_state[k] = json.loads(r.read())
            except Exception:
                pass                       # keep the last-seen state
            w["state"] = last_state.get(k)
            out["workers"].append(w)
        out["pod"] = dict(
            alive_workers=sum(w["alive"] for w in out["workers"]),
            **aggregate_pod([w["state"] for w in out["workers"]]))
        return out

    srv = None
    if args.port:
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(pod_state()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", args.port), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        print(f"# pod view on http://127.0.0.1:{args.port}/pod.json",
              file=sys.stderr, flush=True)

    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            time.sleep(2)
            pod_state()                    # refresh the last-seen cache
        rc = max((p.returncode or 0) for p in procs)
    except KeyboardInterrupt:
        # graceful: workers flush snapshots on SIGINT
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGINT)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
    finally:
        if srv:
            srv.shutdown()
        # authoritative totals come from each worker's final stdout
        # summary (the live /state.json is best-effort: under CPU-bound
        # demo load the workers' status threads can starve)
        totals = {"rounds": 0, "access_units": 0, "streams": 0}
        exited_ok = 0
        for k, p in enumerate(procs):
            tail = (p.stdout.read() or "").strip().splitlines()
            summ = None
            for ln in reversed(tail):
                if ln.startswith("{") and "access_units" in ln:
                    try:
                        summ = json.loads(ln)
                        break
                    except json.JSONDecodeError:
                        pass
            for ln in tail[-3:]:
                print(f"# worker {k}: {ln}", file=sys.stderr)
            if summ:
                exited_ok += 1
                for key in totals:
                    totals[key] += int(summ.get(key, 0))
    print(json.dumps({"metric": "pod_serving", "workers": len(procs),
                      "workers_reporting": exited_ok, **totals}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
