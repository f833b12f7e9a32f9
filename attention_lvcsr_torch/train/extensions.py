"""The training extensions beyond the loop's core ones.

The port's copy of the rest of ``attention_lvcsr_tpu/train/extensions.py``
under the JAX package's names (the core extensions, which training needs,
live in :mod:`attention_lvcsr_torch.train.loop`):

* ``CodeVersion`` and ``CompilationStatistics``, which ``run_training``
  adds to every run;
* ``Plot`` (the channels to ``<path>.json`` and, where matplotlib exists,
  ``<path>.png``) and ``PlotServer`` (the same series over HTTP), which
  ``monitoring.plot`` turns on;
* the debugging extensions ``ProgressBar``, ``LogInputs``, ``NanGuard``,
  ``EmbedShell`` and ``TorchProfiler`` (``torch.profiler`` in place of the
  JAX package's ``JaxProfiler``).

The port's loop runs no ``after_training`` after an error, where the JAX
package's does: ``PlotServer`` and ``TorchProfiler`` also close in
``on_error``.
"""
from __future__ import annotations

import math
import os
import signal
import subprocess
import sys
import time

import numpy as np

from attention_lvcsr_torch.train.loop import SimpleExtension, TrainingExtension


class CodeVersion(TrainingExtension):
    """The git commit of the repository into ``status["code_version"]``
    (``"unknown"`` outside a checkout or without git)."""

    def __init__(self, repo_dir=None):
        self.repo_dir = repo_dir or os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def before_training(self):
        try:
            commit = subprocess.check_output(
                ["git", "rev-parse", "HEAD"], cwd=self.repo_dir,
                stderr=subprocess.DEVNULL).decode().strip()
            self.main_loop.log.status["code_version"] = commit
        except Exception:
            self.main_loop.log.status["code_version"] = "unknown"


class CompilationStatistics(TrainingExtension):
    """The algorithm's ``compile_stats`` (``GradientDescent``:
    ``compile_time_s``, ``num_compiled_shapes``) into the status.

    The JAX package copies them before training only, when its algorithm
    has stepped no batch and the statistics are still empty; the port
    copies them after every batch as well, so that the status holds
    them."""

    def _copy(self):
        stats = getattr(self.main_loop.algorithm, "compile_stats", None)
        if stats:
            self.main_loop.log.status.update(stats)

    def before_training(self):
        self._copy()

    def after_batch(self, batch):
        self._copy()


def _host(x):
    """A batch entry (array or tensor) as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ProgressBar(TrainingExtension):
    """Minimal stderr progress indicator: the batches of the epoch and
    their rate, every ten batches."""

    def before_epoch(self):
        self._count = 0
        self._t0 = time.time()

    def after_batch(self, batch):
        self._count += 1
        if self._count % 10 == 0:
            rate = self._count / (time.time() - self._t0 + 1e-9)
            print(f"\r  batch {self._count} ({rate:.1f} it/s)",
                  end="", file=sys.stderr)

    def after_epoch(self):
        print("", file=sys.stderr)


class LogInputs(SimpleExtension):
    """Debug dump of the first four label rows of a batch (and the
    task loss's ``min_gain``) through ``data.pretty_print``, to stderr or
    appended to ``dump_path`` (the reference's LogInputs/LogInputsGains,
    lvsr/extensions.py:94-154)."""

    def __init__(self, data, dump_path=None, with_gains=False, **conditions):
        self.data = data
        self.dump_path = dump_path
        self.with_gains = with_gains
        conditions.setdefault("every_n_batches", 100)
        super().__init__(**conditions)

    def do(self, which_callback, *args):
        batch = args[0] if args else None
        if batch is None or "labels" not in batch:
            return
        out = sys.stderr if not self.dump_path else open(self.dump_path, "a")
        it = self.main_loop.log.status["iterations_done"]
        print(f"--- inputs at iteration {it} ---", file=out)
        labels = _host(batch["labels"])
        mask = batch.get("labels_mask")
        mask = _host(mask) if mask is not None else None
        for b in range(min(4, len(labels))):
            L = int(mask[b].sum()) if mask is not None else labels.shape[1]
            print(" ", self.data.pretty_print(labels[b][:L], None),
                  file=out)
        if self.with_gains:
            gains = self.main_loop.log.current_row.get("min_gain")
            if gains is not None:
                print(f"  min_gain={gains}", file=out)
        if self.dump_path:
            out.close()


def _numeric(value):
    return isinstance(value, (int, float))


class Plot(SimpleExtension):
    """The training curves written to disk every ``every_n_batches``
    (default 100) batches and after each epoch: the series of each
    channel, ``{name: [[iteration, value], ...]}``, to ``<path>.json``,
    and the channel groups drawn to ``<path>.png`` where matplotlib
    exists.  A failure to draw is printed and training goes on; the JSON
    is always written."""

    def __init__(self, path, channels, **conditions):
        self.path = path
        self.channels = channels
        conditions.setdefault("every_n_batches", 100)
        conditions.setdefault("after_epoch", True)
        super().__init__(**conditions)

    def do(self, which_callback, *args):
        import json
        from attention_lvcsr_torch.utils.notebook import plot_channels
        log = self.main_loop.log
        try:
            plot_channels(log, self.channels, save_to=self.path + ".png")
        except Exception as exc:    # the picture must never stop training
            print(f"Plot: {exc}", file=sys.stderr)
        series = {}
        for group in self.channels:
            for name in group:
                times, values = log.channel(name)
                series[name] = [[t, float(v)] for t, v in zip(times, values)
                                if _numeric(v)]
        with open(self.path + ".json", "w") as f:
            json.dump(series, f)


class PlotServer(TrainingExtension):
    """Live training curves over HTTP: a standard-library server on a
    background thread serves ``GET /`` (a page that draws each channel
    group on a canvas and refreshes every five seconds), ``GET
    /data.json`` (the finite numeric series of each group) and 404 for
    any other path.  It listens on ``127.0.0.1`` only (the JAX package's
    listens on every interface).  ``port`` 0 takes a free port, which
    ``port`` then holds; the server shuts down after training."""

    PAGE = """<!doctype html><html><head><title>{title}</title><style>
    body{{font-family:sans-serif;background:#fafafa;margin:20px}}
    .chart{{display:inline-block;margin:10px;background:#fff;
            border:1px solid #ddd;padding:8px}}
    h3{{margin:4px 0;font-size:14px}}</style></head><body>
    <h2>{title}</h2><div id="charts"></div><script>
    const palette=['#1f77b4','#ff7f0e','#2ca02c','#d62728','#9467bd'];
    async function refresh(){{
      const groups=await (await fetch('data.json')).json();
      const root=document.getElementById('charts');root.innerHTML='';
      groups.forEach(function(group,gi){{
        const div=document.createElement('div');div.className='chart';
        const names=Object.keys(group);
        div.innerHTML='<h3>'+names.join(' / ')+'</h3>';
        const cv=document.createElement('canvas');
        cv.width=420;cv.height=220;div.appendChild(cv);root.appendChild(div);
        const ctx=cv.getContext('2d');
        let xs=[],ys=[];
        names.forEach(n=>group[n].forEach(p=>{{xs.push(p[0]);ys.push(p[1]);}}));
        if(!xs.length)return;
        const x0=Math.min(...xs),x1=Math.max(...xs)||1;
        const y0=Math.min(...ys),y1=Math.max(...ys);
        const sx=t=>10+400*(t-x0)/Math.max(x1-x0,1e-9);
        const sy=v=>205-190*(v-y0)/Math.max(y1-y0,1e-9);
        names.forEach(function(n,i){{
          ctx.strokeStyle=palette[i%palette.length];ctx.beginPath();
          group[n].forEach(function(p,k){{
            k?ctx.lineTo(sx(p[0]),sy(p[1])):ctx.moveTo(sx(p[0]),sy(p[1]));
          }});ctx.stroke();
          ctx.fillStyle=palette[i%palette.length];
          ctx.fillText(n+' '+(group[n].length?
            group[n][group[n].length-1][1].toPrecision(4):''),15,12+12*i);
        }});
        ctx.fillStyle='#888';
        ctx.fillText(y1.toPrecision(3),350,14);
        ctx.fillText(y0.toPrecision(3),350,215);
      }});
    }}
    refresh();setInterval(refresh,5000);</script></body></html>"""

    def __init__(self, channels, port=0, title="training"):
        self.channels = channels
        self.port = port
        self.title = title
        self._httpd = None

    def series(self):
        """What ``/data.json`` serves: per group, ``{name: [[iteration,
        value], ...]}`` of the finite numeric values."""
        log = self.main_loop.log
        groups = []
        for group in self.channels:
            data = {}
            for name in group:
                times, values = log.channel(name)
                data[name] = [[int(t), float(v)]
                              for t, v in zip(times, values)
                              if _numeric(v) and math.isfinite(float(v))]
            groups.append(data)
        return groups

    def before_training(self):
        import http.server
        import json
        import threading

        ext = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/index.html"):
                    body = ext.PAGE.format(title=ext.title).encode()
                    ctype = "text/html"
                elif self.path.lstrip("/") == "data.json":
                    body = json.dumps(ext.series()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        print(f"PlotServer: live plots at http://localhost:{self.port}/",
              file=sys.stderr)

    def after_training(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def on_error(self, exc):
        self.after_training()


class NanGuard(TrainingExtension):
    """Raise ``FloatingPointError`` naming the field, its value and the
    iteration as soon as one of ``fields`` in the log is not finite.

    Recorded deviation: the JAX package's loop records a step's monitors
    one batch late, so its guard raises at the batch after the one that
    produced the NaN; the port's loop records them right after the step,
    and the port's guard raises at that batch."""

    def __init__(self, fields=("train_cost", "total_gradient_norm")):
        self.fields = fields

    def after_batch(self, batch):
        log = self.main_loop.log
        for name in self.fields:
            value = log.current_row.get(name)
            if value is None:
                value = log.last_value(name)
            if isinstance(value, float) and not math.isfinite(value):
                raise FloatingPointError(
                    f"non-finite {name}={value} at iteration "
                    f"{log.status['iterations_done']}")


class TorchProfiler(TrainingExtension):
    """A ``torch.profiler`` trace of the batches ``start_batch`` to
    ``start_batch + num_batches`` (counted by the iterations done before
    a batch): CPU and CUDA activity when the algorithm's recognizer is on
    the card, CPU alone otherwise.  The Chrome trace goes to
    ``<logdir>/trace_<start>_<stop>.json`` (``path`` once written),
    readable in chrome://tracing or Perfetto."""

    def __init__(self, logdir, start_batch=10, num_batches=5):
        self.logdir = logdir
        self.start_batch = start_batch
        self.stop_batch = start_batch + num_batches
        self.path = None
        self._prof = None

    def _activities(self):
        from torch.profiler import ProfilerActivity
        recognizer = getattr(self.main_loop.algorithm, "recognizer", None)
        device = getattr(recognizer, "device", None)
        if device is not None and device.type == "cuda":
            return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        return [ProfilerActivity.CPU]

    def before_batch(self, batch):
        it = self.main_loop.log.status["iterations_done"]
        if it == self.start_batch and self._prof is None:
            import torch.profiler
            self._prof = torch.profiler.profile(
                activities=self._activities())
            self._prof.start()

    def after_batch(self, batch):
        it = self.main_loop.log.status["iterations_done"]
        if self._prof is not None and it >= self.stop_batch:
            self._stop()

    def _stop(self):
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir, f"trace_{self.start_batch}_{self.stop_batch}.json")
        prof.export_chrome_trace(self.path)

    def after_training(self):
        if self._prof is not None:
            self._stop()

    def on_error(self, exc):
        self.after_training()


class EmbedShell(TrainingExtension):
    """SIGUSR1 drops the running loop into pdb (the reference's
    EmbedIPython role); nothing outside the main thread."""

    def before_training(self):
        def handler(signum, frame):
            import pdb
            pdb.Pdb().set_trace(frame)
        try:
            signal.signal(signal.SIGUSR1, handler)
        except ValueError:
            pass                # not the main thread
