"""Metrics (the port's copy of paddle_tpu/metric/__init__.py: Metric,
Accuracy, Precision, Recall, Auc and the functional `accuracy`).

Accuracy, Precision and Recall reduce on the tensor's device and bring
only the resulting scalars to the host, in one read an update: they run
once a batch inside Model.fit's loop. Auc keeps the reference's host-side
streaming histogram.

Ties: the reference ranks with `jnp.argsort(-p)`, a stable sort, so that
among equal logits the lower class index ranks first. `torch.topk`, and
`torch.argsort` without `stable=True`, may order ties otherwise (bfloat16
logits tie often); the port sorts `-p` with `stable=True`, the same
order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _dev(x):
    """x as a tensor, on its own device (no host round trip for tensors)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _ranked(p, k):
    """The indices of the k largest entries of each row of p, the largest
    first, ties by the lower index (the reference's stable argsort)."""
    return torch.argsort(-p, dim=-1, stable=True)[..., :k]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        p = _dev(pred)
        lab = _dev(label)
        if lab.ndim == p.ndim and lab.shape[-1] > 1:  # one-hot
            lab = torch.argmax(lab, dim=-1)
        if lab.ndim == p.ndim:
            lab = lab.squeeze(-1)
        correct = _ranked(p, self.maxk) == lab[..., None].to(torch.int64)
        return correct.to(torch.float32)

    def update(self, correct, *args):
        c = _dev(correct)
        # one read to the host for every k, not the whole mask
        sums = torch.stack([c[..., :k].sum() for k in self.topk]).tolist()
        n = int(np.prod(tuple(c.shape[:-1])))
        res = []
        for i, ck_sum in enumerate(sums):
            self.total[i] += ck_sum
            self.count[i] += n
            res.append(ck_sum / n if n else 0.0)
        return res if len(res) > 1 else res[0]

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res if len(res) > 1 else res[0]

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


def _flags(preds, labels):
    return _dev(preds).reshape(-1) > 0.5, _dev(labels).reshape(-1).to(
        torch.int32)


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        p, lab = _flags(preds, labels)
        tp, fp = torch.stack([(p & (lab == 1)).sum(),
                              (p & (lab == 0)).sum()]).tolist()
        self.tp += int(tp)
        self.fp += int(fp)

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        p, lab = _flags(preds, labels)
        tp, fn = torch.stack([(p & (lab == 1)).sum(),
                              (~p & (lab == 1)).sum()]).tolist()
        self.tp += int(tp)
        self.fn += int(fn)

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lab = _np(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            auc += self._stat_neg[i] * (tot_pos + self._stat_pos[i] / 2.0)
            tot_pos += self._stat_pos[i]
            tot_neg += self._stat_neg[i]
        return auc / (tot_pos * tot_neg) if tot_pos * tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The functional metric op: the share of rows whose label is among
    the k largest logits, a 0-d float32 tensor on the input's device."""
    p = _dev(input)
    lab = _dev(label).reshape(-1).to(torch.int64)
    corr = (_ranked(p, k) == lab[:, None]).any(-1)
    return corr.to(torch.float32).mean()
