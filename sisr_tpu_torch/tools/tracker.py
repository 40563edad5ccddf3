"""Lightweight JSONL experiment tracker (copy of sisr_tpu's ``tools/tracker.py``).

Stands in for the reference's optional Aim integration (ref:
training_handler.py:20-22, 127-145, 242-246, 284-286, 311-312): runs are tracked as
append-only JSONL event streams (one file per run under
``<aim_home>/<experiment>/<run>.jsonl``) that any dashboard can tail, with the records
of sisr_tpu's tracker.  The API mirrors the subset of aim.Session the reference uses.
"""
import json
import math
import os
import time


class JsonlTracker:
    def __init__(self, experiment, repo, run=None):
        self.experiment = experiment
        run = run or ('run_%d' % int(time.time()))
        run_dir = os.path.join(repo, experiment)
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, '%s.jsonl' % run)
        self._fh = open(self.path, 'a')
        self._emit({'event': 'start', 'experiment': experiment, 'run': run})

    @staticmethod
    def _finite(obj):
        # bare NaN/Infinity tokens are not valid JSON — a diverged loss would
        # break every strict parser tailing the stream; encode them as null
        if isinstance(obj, float) and not math.isfinite(obj):
            return None
        if hasattr(obj, 'dtype') and getattr(obj, 'ndim', 1) == 0:
            f = float(obj)  # numpy scalars route through here, not the float branch
            return None if not math.isfinite(f) else obj
        if isinstance(obj, dict):
            return {k: JsonlTracker._finite(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [JsonlTracker._finite(v) for v in obj]
        return obj

    def _emit(self, record):
        record.setdefault('time', time.time())
        self._fh.write(json.dumps(self._finite(record), default=_jsonable) + '\n')
        self._fh.flush()

    def set_params(self, params, name=None):
        """(aim.Session.set_params equivalent)"""
        self._emit({'event': 'params', 'name': name, 'params': params})

    def track(self, value, name, epoch=None, **context):
        """(aim.Session.track equivalent)"""
        self._emit({'event': 'metric', 'name': name, 'value': value, 'epoch': epoch,
                    **context})

    def close(self):
        self._emit({'event': 'end'})
        self._fh.close()


def _jsonable(obj):
    try:
        return float(obj)
    except (TypeError, ValueError):
        return str(obj)
