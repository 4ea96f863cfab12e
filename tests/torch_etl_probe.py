"""A stand-in worker target for the port's ETL service tests: it runs the
real ``_etl_worker`` of ``deeplearning4j_tpu_torch.data.etl_service`` on a
thread of the spawned worker process and, once that worker has produced a
batch, writes the process's imported ``torch`` modules to
``$TDLT_ETL_PROBE_DIR/<worker id>.json``. This module imports nothing of
torch itself."""

import json
import os
import threading
import time


def worker_and_report(spec, worker_id, *args):
    from deeplearning4j_tpu_torch.data import etl_service

    counters = args[-1]
    t = threading.Thread(target=etl_service._etl_worker, args=(spec, worker_id) + args,
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 60.0
    while counters[2 * worker_id] + counters[2 * worker_id + 1] == 0 and t.is_alive() \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    import sys

    torch_mods = sorted(m for m in sys.modules if m == "torch" or m.startswith("torch."))
    path = os.path.join(os.environ["TDLT_ETL_PROBE_DIR"], f"{worker_id}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"torch": torch_mods, "produced": True}, f)
    os.replace(path + ".tmp", path)
    t.join()
