"""What the benchmark puts around calls into the port: spans, host-side counts, a capture.

Each probe replaces an attribute of a port module or class while it is
installed and restores it after, as `flexs_tpu_torch.profile_main_path`
does; the package itself carries no instrumentation.  A probe whose target
is gone raises, so a renamed method cannot drop out of a metric.
"""
import contextlib
import functools

from torch.profiler import record_function

from benchmark.work import Lookup


@contextlib.contextmanager
def replaced(swaps):
    """Set each `(owner, attr, make)` to `make(current)` while inside, in order.

    Swaps of one attribute nest: a later one wraps what the earlier one set.
    """
    missing = [f"{getattr(o, '__name__', o)}.{a}" for o, a, _ in swaps if not hasattr(o, a)]
    if missing:
        raise AttributeError(f"probe targets not found: {missing}")
    originals = [(o, a, getattr(o, a)) for o, a, _ in swaps]
    try:
        for o, a, make in swaps:
            setattr(o, a, make(getattr(o, a)))
        yield
    finally:
        for o, a, fn in reversed(originals):
            setattr(o, a, fn)


def span(label):
    """A wrapper factory: a `record_function(label)` range around every call."""

    def make(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)

        return wrapper

    return make


class Capture:
    """Every `RunResult` the port's fused runs return, in order, as the timed path made it."""

    def __init__(self):
        self.results = []

    def make(self, fn):
        @functools.wraps(fn)
        def run_cells(run):
            result = fn(run)
            self.results.append(result)
            return result

        return run_cells

    def take(self):
        out, self.results = self.results, []
        return out


class LookupCount:
    """Host-side counts of `CellRun.dists_to_cache`: queries and each cell's filled cache rows.

    The fills are the runner's host lists (`n_cache`), read without a sync.
    """

    def __init__(self):
        self.total = Lookup()

    def make(self, fn):
        @functools.wraps(fn)
        def dists_to_cache(run, packed):
            self.total.add(packed.shape[1], run.n_cache, run.words, run.bits)
            return fn(run, packed)

        return dists_to_cache


class RowCount:
    """Rows the oracle was asked to score (padding to its passes apart)."""

    def __init__(self):
        self.rows = 0

    def make(self, fn):
        @functools.wraps(fn)
        def oracle(params, tokens):
            self.rows += tokens[..., 0].numel()
            return fn(params, tokens)

        return oracle


class DistSample:
    """A sample of what `CellRun.dists_to_cache` returned, drawn from the run's seed.

    Calls are taken at gaps drawn from `rng` that grow by a quarter each
    take, so a short run and a long window are both sampled from their
    first calls to their last.  Of a taken call: one cell, drawn, and up to
    `rows` consecutive query rows, with the cache rows the call was given,
    the cell's fill and the distances it returned, cloned on the device
    (no sync in the window).  At most `most` calls.
    """

    def __init__(self, rng, rows=32, most=64):
        self.rng, self.rows, self.most = rng, rows, most
        self.samples, self.calls, self.gap = [], 0, 1.0
        self.next_call = int(rng.integers(2))

    def make(self, fn):
        @functools.wraps(fn)
        def dists_to_cache(run, packed):
            out = fn(run, packed)
            if self.calls == self.next_call and len(self.samples) < self.most:
                self._take(run, packed, out)
                self.gap *= 1.25
                self.next_call += 1 + int(self.rng.integers(int(2 * self.gap) + 1))
            self.calls += 1
            return out

        return dists_to_cache

    def _take(self, run, packed, out):
        c = int(self.rng.integers(out.shape[0]))
        m = out.shape[1]
        lo = int(self.rng.integers(max(1, m - self.rows + 1)))
        rows = slice(lo, lo + self.rows)
        self.samples.append({
            "queries": packed[c, rows].clone(), "cache": run.cache_pk[c, :out.shape[2]].clone(),
            "fill": run.n_cache_t[c].clone(), "dists": out[c, rows].clone(),
            "bits": run.bits, "per_word": run.per_word, "length": run.L})

    def settle(self):
        """The samples on the host, as numpy (after the window)."""
        return [{k: v.cpu().numpy() if hasattr(v, "cpu") else v for k, v in s.items()}
                for s in self.samples]
