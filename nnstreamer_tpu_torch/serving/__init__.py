"""Serving: the versioned model store, device placement (logical
devices, the lease ledger), sharded LLM serving, and the supervised
worker pool (pool.py / worker.py: N pipeline copies in child processes
behind one query server, with crash isolation, liveness, backoff restart
under a restart-budget circuit, conservation-exact `worker_lost`
accounting and graceful drain). More of the serving stack is still to
be ported."""


def __getattr__(name):
    # pool/worker are lazy: importing the store must not pull in the
    # multiprocessing machinery (children import this package too)
    if name in ("WorkerPool", "PooledQueryServer", "proc_alive"):
        from nnstreamer_tpu_torch.serving import pool as _pool

        return getattr(_pool, name)
    if name == "WorkerSpec":
        from nnstreamer_tpu_torch.serving.worker import WorkerSpec

        return WorkerSpec
    raise AttributeError(name)
