"""Clean twin of hs001_bad: the same shapes of code, no per-iteration or
repeated host read."""
import numpy as np
import torch


def hot_single_read(x):
    n = x.sum().item()  # one read per call: the contract
    return [n for _ in range(3)]


def hot_chain_read_once(x):
    host = x.cpu().numpy()  # one read, the chain's innermost call
    return [int(v) for v in host]  # host ints after the read


def hot_host_sequences(queries, dev):
    out = []
    for q in queries:
        w = np.asarray([q, q], np.float32)  # built on the host
        out.append(w)
    return torch.as_tensor(np.stack(out), device=dev)  # one copy


def hot_device_work(chunks, dev):
    out = []
    for c in chunks:
        out.append(c.to(torch.int32))  # a cast on the device, no read
        out.append(torch.zeros(3, device=dev))  # filled on the device
        out.append(c[:, 0])  # a basic index, no copy
    return out


def hot_exclusive_branches(mask, fast):
    if fast:
        n_qual = mask.sum(1).cpu()
    else:
        n_qual = mask.sum(1).cpu()  # other arm: one of the two runs
    return n_qual


def hot_rebound(run, ids):
    a = ids.cpu()
    ids = run(ids)  # rebound: the next read is a NEW value
    b = ids.cpu()
    return a, b


def hot_lazy_memo(mask, estimated):
    n_qual = None
    if not estimated:
        n_qual = mask.sum(1).cpu()
    if n_qual is None:  # memo guard: at most one of the two reads runs
        n_qual = mask.sum(1).cpu()
    return n_qual


class Hot:
    def run(self, chunk):
        return self._step(chunk)  # called once, not in a loop

    def _step(self, c):
        return c.cpu()


class Cold:
    def run(self, chunks):
        return [self._step(c) for c in chunks]  # not a hot function

    def _step(self, c):
        return c.cpu()
