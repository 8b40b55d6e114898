"""Seeded HS001 violations: torch's host reads in hot host functions."""
import numpy as np
import torch


def hot_item(chunks):
    out = []
    for c in chunks:
        out.append(c.sum().item())  # HS001: .item() per iteration
    return out


def hot_tolist(x, n):
    while x.tolist() and n:  # HS001: a While's test runs every iteration
        n -= 1
    return n


def hot_cpu_loop(chunks):
    out = []
    for c in chunks:
        out.append(c.cpu())  # HS001: .cpu() per iteration
    return out


def hot_numpy(chunks):
    out = []
    for c in chunks:
        out.append(c.numpy())  # HS001: .numpy() per iteration
    return out


def hot_to_cpu(chunks):
    out = []
    for c in chunks:
        out.append(c.to("cpu"))  # HS001: .to("cpu") per iteration
    return out


def hot_to_device_cpu(chunks):
    out = []
    for c in chunks:
        out.append(c.to(device="cpu"))  # HS001: .to(device="cpu")
    return out


def hot_asarray(chunks):
    out = []
    for c in chunks:
        out.append(np.asarray(c))  # HS001: np.asarray per iteration
    return out


def hot_coerce(chunks):
    total = 0
    for c in chunks:
        total += int(c.sum())  # HS001: int() of a tensor per iteration
    return total


def hot_synchronize(chunks):
    for c in chunks:
        c.add_(1)
        torch.cuda.synchronize()  # HS001: a device sync per iteration
    return chunks


def hot_h2d(rows, dev):
    out = []
    for r in rows:
        out.append(torch.as_tensor(r, device=dev))  # HS001: H2D per iteration
    return out


def hot_list_index(x, groups):
    out = []
    for cols in groups:
        out.append(x[:, list(cols)])  # HS001: the index goes host->device
    return out


def hot_duplicate(ids):
    a = ids.cpu()
    b = ids.cpu()  # HS001: the same value read twice
    return a, b


class Hot:
    def run(self, chunks):
        return [self._step(c) for c in chunks]

    def _step(self, c):
        return c.cpu()  # HS001: runs once per element of run's loop
