"""Replay pytest-xdist's `load` scheduler (xdist 3.8) from one run's
per-test durations, to see how a change in the collected items moves the
tier-1 run's end time and its passes at a time limit.

    python -m pytest tests/ -q -m 'not slow' --collect-only > items.txt
    python tools/xdist_replay.py --junit run.xml --items items.txt \\
        [--items other_items.txt ...] [--crash NODEID] [--cut 1470] \\
        [--samples 100 --sigma 0.15 --slowdown 1.2]

The model: each of --workers workers first gets a chunk of N // workers
// 4 consecutive items; on every completion the controller tops a worker
up (`LoadScheduling.check_schedule`: below max(2, pending // workers //
4) items it sends up to max(2, pending // workers // 2), unless the last
test took >= 0.1 s and two are still queued); a worker runs an item only
with another queued behind it, or after it was told to shut down.  The
--crash item kills its worker after a time drawn from --crash-time; the
rest of that worker's queue goes to the end of the pending list and a
replacement joins --restart seconds later.  Durations are the junit
`time` of each test (setup, call and teardown); an item missing from the
junit file counts 0 s and passes.  --samples draws per-test lognormal
noise (--sigma) on top of a uniform --slowdown and prints quantiles of
the passes at --cut.
"""
import argparse
import heapq
import random
import xml.etree.ElementTree as ET


def load_junit(path):
    """nodeid -> (seconds, 'pass' | 'fail' | 'skip')."""
    out = {}
    for tc in ET.parse(path).getroot().iter("testcase"):
        nodeid = tc.get("classname").replace(".", "/") + ".py::" + \
            tc.get("name")
        status = "pass"
        for child in tc:
            if child.tag in ("failure", "error"):
                status = "fail"
            elif child.tag == "skipped":
                status = "skip"
        out[nodeid] = (float(tc.get("time", 0)), status)
    return out


def load_items(path):
    return [line.strip() for line in open(path) if "::" in line]


def replay(dur, status, crash=None, crash_time=60.0, workers=6, start=15.0,
           restart=15.0, cut=float("inf")):
    """(passes completed by cut, items completed by cut, last completion)
    for items 0..N-1 with durations dur and statuses status."""
    n_items = len(dur)
    pending = list(range(n_items))
    queue, stopping, running, events, done = {}, {}, set(), [], []
    counter = [0]

    def push(t, kind, node):
        counter[0] += 1
        heapq.heappush(events, (t, counter[0], kind, node))

    def send(node, num):
        queue[node].extend(pending[:num])
        del pending[:num]

    def maybe_run(node, t):
        q = queue.get(node)
        if node in running or not q or (len(q) < 2 and not stopping[node]):
            return
        running.add(node)
        if q[0] == crash:
            push(t + crash_time, "crash", node)
        else:
            push(t + dur[q[0]], "done", node)

    def check_schedule(node, t, last=0.0):
        if stopping[node]:
            maybe_run(node, t)
            return
        if pending:
            lo = max(2, len(pending) // len(queue) // 4)
            hi = max(2, len(pending) // len(queue) // 2)
            q = queue[node]
            if len(q) < lo and not (last >= 0.1 and len(q) >= 2):
                send(node, hi - len(q))
        else:
            stopping[node] = True
        maybe_run(node, t)

    for node in range(workers):
        queue[node], stopping[node] = [], False
    chunk = max(n_items // workers // 4, 2)
    for node in range(workers):
        send(node, chunk)
        maybe_run(node, start)
    next_node = workers
    while events:
        t, _, kind, node = heapq.heappop(events)
        if t > cut:
            break
        running.discard(node)
        if kind == "done":
            item = queue[node].pop(0)
            done.append((t, item))
            check_schedule(node, t, dur[item])
        elif kind == "crash":
            q = queue.pop(node)
            stopping.pop(node)
            done.append((t, q.pop(0)))
            pending.extend(q)
            for other in list(queue):
                check_schedule(other, t)
            push(t + restart, "join", next_node)
            next_node += 1
        else:  # a replacement worker joins
            queue[node], stopping[node] = [], False
            for other in list(queue):
                check_schedule(other, t)
    passes = sum(1 for _, i in done if status[i] == "pass")
    return passes, len(done), max((t for t, _ in done), default=0.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--junit", required=True)
    ap.add_argument("--items", action="append", required=True)
    ap.add_argument("--crash")
    ap.add_argument("--crash-time", type=float, nargs=2, default=(30, 150))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--start", type=float, default=15.0)
    ap.add_argument("--restart", type=float, default=15.0)
    ap.add_argument("--cut", type=float, default=1470.0)
    ap.add_argument("--samples", type=int, default=0)
    ap.add_argument("--sigma", type=float, default=0.15)
    ap.add_argument("--slowdown", type=float, default=1.0)
    args = ap.parse_args()
    junit = load_junit(args.junit)
    for path in args.items:
        items = load_items(path)
        base = [junit.get(i, (0.0, "pass")) for i in items]
        status = [s for _, s in base]
        crash = items.index(args.crash) if args.crash in items else None
        kw = dict(crash=crash, workers=args.workers, start=args.start,
                  restart=args.restart)
        mid = sum(args.crash_time) / 2
        full = replay([d for d, _ in base], status, crash_time=mid, **kw)
        cut = replay([d for d, _ in base], status, crash_time=mid,
                     cut=args.cut, **kw)
        print(f"{path}: {len(items)} items, end {full[2]:.0f} s, "
              f"{full[0]} passes; at {args.cut:.0f} s {cut[0]} passes")
        if args.samples:
            rng = random.Random(0)
            counts = sorted(replay(
                [d * args.slowdown * rng.lognormvariate(0, args.sigma)
                 for d, _ in base], status,
                crash_time=rng.uniform(*args.crash_time), cut=args.cut,
                **kw)[0] for _ in range(args.samples))
            q = [counts[int(f * (len(counts) - 1))]
                 for f in (0, 0.1, 0.5, 0.9, 1)]
            print(f"  {args.samples} samples, slowdown {args.slowdown}: "
                  f"passes at the cut min/p10/median/p90/max {q}")


if __name__ == "__main__":
    main()
