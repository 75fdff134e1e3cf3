"""Open-loop HTTP load: POSTs each request of a schedule at its due time
and reads its whole body, from a process of its own.

    python loadgen.py SCHEDULE.json  ->  one JSON line a request on stdout

The schedule holds the server's address, the requests' texts and their due
times (seconds after the start). A request is handed to a pool of threads
at its due time whatever the others are doing; its latency runs from its
due time to the last byte of its body. Each line gives the request's
index, due time, the time its thread sent it, the time its last byte came (None if it failed), the
status, the X-Chunks header and the SHA-1 of the body's PCM samples (the
bytes after the 44-byte RIFF header). Only the standard library is
imported."""

from __future__ import annotations

import hashlib
import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HEADER = 44


def main(path: str) -> int:
    with open(path, encoding="utf8") as f:
        sched = json.load(f)
    host, port = sched["host"], sched["port"]
    out_lock = threading.Lock()

    def send(i: int, text: str, due: float, t0: float):
        rec = {"i": i, "due": due, "sent": time.perf_counter() - t0, "done": None,
               "status": None, "chunks": None, "sha1": None}
        body = json.dumps({"text": text}).encode()
        c = http.client.HTTPConnection(host, port, timeout=sched["timeout"])
        try:
            c.request("POST", "/synthesize", body, {"Content-Type": "application/json"})
            resp = c.getresponse()
            data = resp.read()
            rec["done"] = time.perf_counter() - t0
            rec["status"] = resp.status
            rec["chunks"] = resp.getheader("X-Chunks")
            rec["sha1"] = hashlib.sha1(data[HEADER:]).hexdigest()
        except (OSError, http.client.HTTPException) as e:
            rec["error"] = repr(e)
        finally:
            c.close()
        with out_lock:
            sys.stdout.write(json.dumps(rec) + "\n")

    pool = ThreadPoolExecutor(max_workers=sched["threads"])
    t0 = time.perf_counter()
    for i, (text, due) in enumerate(zip(sched["texts"], sched["due"])):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        pool.submit(send, i, text, due, t0)
    pool.shutdown(wait=True)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
