"""The one general generator: a traffic file's ``kind`` picks a client
loop, and its other keys set it up.  Every kind gives the harness the same
surface: ``setup()`` (plan, frames, warm-up of this cell's shapes alone),
``request(i)`` (one request, timed on the host clock, ending in a
synchronize), ``inputs(i)`` (the frames request ``i`` sent), ``release()``
(drops the program's state before the reference runs), and the counts
``frames_per_request``, ``passes_per_request``, ``launch_batch`` and
``pool_shape``, the ``(n, batch)`` of the frames it draws.
Frames are drawn N(0, 1) on the device from the run's generator.
"""
import time
from fractions import Fraction


class Offline:
    """One client sends a batch of ``batch`` frames through
    ``CNNApi.apply`` on the plan at ``rate``, waits for its logits and
    sends the next.  The frames are a pool of ``pool_batches`` distinct
    batches, cycled: the forward does no data-dependent work."""

    def __init__(self, env, traffic):
        self.env = env
        self.rate = Fraction(traffic["rate"])
        self.batch = self.launch_batch = self.frames_per_request = traffic["batch"]
        self.passes_per_request = 1
        self.pool_batches = traffic["pool_batches"]
        self.pool_shape = (self.pool_batches, self.batch)

    def setup(self):
        e = self.env
        self.plan = e.api.plan(e.cfg, self.rate)
        self.pool = e.frames(*self.pool_shape)
        for i in range(2):
            self.request(i)

    def request(self, i):
        e = self.env
        x = self.pool[i % self.pool_batches]
        t0 = time.perf_counter()
        y = e.api.apply(e.params, x, e.cfg, plan=self.plan)
        t1 = time.perf_counter()
        e.sync()
        return t0, t1, time.perf_counter(), y

    def inputs(self, i):
        return self.pool[i % self.pool_batches]

    def release(self):
        self.plan = None


class Stream:
    """Runs of ``frames_per_run`` frames, already on the device, through
    the stream engine (``CNNApi.serve``): ``stages`` stages of the plan at
    ``rate``, micro-batches of ``microbatch`` frames on the plan's kernel
    tiles, constant arrival at the plan's best rate, ``execute`` as
    given.  Each run ends when its outputs are synchronized."""

    def __init__(self, env, traffic):
        self.env = env
        self.rate = Fraction(traffic["rate"])
        self.stages = traffic["stages"]
        self.launch_batch = traffic["microbatch"]
        self.frames_per_request = traffic["frames_per_run"]
        self.passes_per_request = -(-self.frames_per_request // self.launch_batch)
        self.execute = traffic["execute"]
        self.pool_shape = (1, self.frames_per_request)

    def setup(self):
        from repro_torch.serving import ServeConfig
        from repro_torch.serving.cnn_stream import best_rate_frames

        e = self.env
        self.partition = e.api.partition(e.cfg, self.rate, self.stages)
        self.config = ServeConfig(
            microbatch=self.launch_batch, arrival=best_rate_frames(self.partition),
            execute=self.execute, dtype=e.dtype)
        self.frames = e.frames(*self.pool_shape)[0]
        self.request(0)

    def request(self, i):
        e = self.env
        t0 = time.perf_counter()
        out, _ = e.api.serve(e.params, self.frames, e.cfg, input_rate=self.rate,
                             n_stages=self.stages, config=self.config,
                             rate_matched=True)
        t1 = time.perf_counter()
        e.sync()
        return t0, t1, time.perf_counter(), out

    def inputs(self, i):
        return self.frames

    def release(self):
        self.partition = self.config = None


KINDS = {"offline": Offline, "stream": Stream}


def driver(env, traffic):
    kind = KINDS.get(traffic.get("kind"))
    if kind is None:
        raise ValueError(f"unknown traffic kind {traffic.get('kind')!r}; "
                         f"known: {', '.join(KINDS)}")
    return kind(env, traffic)
