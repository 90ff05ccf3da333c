"""Panel ingestion: cleaned CSVs → tensors (``hfrep_tpu/core/data.py``).

The JAX package reads the CSVs with pandas; the port reads them with the
``csv`` module and Python's ``float()``, so nothing on the training path
needs pandas.  ``float()`` is correctly rounded and pandas' default
parser is not, so the two can differ in the last bit of a float64, but
:func:`load_panel` casts to float32 first, where they agree on every
value of the committed panel (``results/rederived_cleaned/``).

Data shapes: 337 months 1994-04-30 → 2022-04-30; 22 factor/ETF columns,
13 hedge-fund indices, 1 risk-free column.
"""

from __future__ import annotations

import csv
import dataclasses
import pickle
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from hfrep_tpu_torch.config import DataConfig
from hfrep_tpu_torch.core import scaler as mm
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.core.sampling import sample_windows
from hfrep_tpu_torch.utils.safe_pickle import safe_pickle_load


class Frame(NamedTuple):
    """A CSV's columns (the ``Date`` column apart), its dates and its
    values as float64 (T, len(columns))."""

    columns: List[str]
    dates: Optional[np.ndarray]     # (T,) datetime64[D]; None when date=False
    values: np.ndarray


def read_csv(loc, date: bool = True) -> Frame:
    """CSV → :class:`Frame`, the ``Date`` column parsed to
    ``datetime64[D]`` (``helper.py:18-23``)."""
    with open(loc, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], [r for r in rows[1:] if r]
    dates = None
    if date:
        at = header.index("Date")
        dates = np.array([r[at][:10] for r in body], dtype="datetime64[D]")
        header = header[:at] + header[at + 1:]
        body = [r[:at] + r[at + 1:] for r in body]
    values = np.array([[float(v) for v in r] for r in body], dtype=np.float64)
    return Frame(columns=header, dates=dates,
                 values=values.reshape(len(body), len(header)))


def dic_read(loc) -> dict:
    """Pickle load (``helper.py:26-29``) via the restricted unpickler."""
    with open(loc, "rb") as f:
        return safe_pickle_load(f)


def dic_save(dic: dict, loc) -> dict:
    """Pickle dump with read-back through the restricted unpickler
    (``helper.py:155-162``): only plain data may be saved."""
    with open(loc, "wb") as f:
        pickle.dump(dic, f)
    return dic_read(loc)


@dataclasses.dataclass
class Panel:
    """The joined monthly-return panel and its provenance."""

    factors: torch.Tensor           # (T, 22) float32
    hf: torch.Tensor                # (T, 13)
    rf: torch.Tensor                # (T, 1)
    dates: np.ndarray               # (T,) datetime64[D], host-side metadata
    factor_names: List[str]
    hf_names: List[str]
    factor_fullnames: Dict[str, str]
    hf_fullnames: Dict[str, str]

    @property
    def n_months(self) -> int:
        return self.factors.shape[0]

    def joined(self, include_rf: bool = False) -> torch.Tensor:
        """factor ⋈ hf (⋈ rf): the GAN training panel, 35 features, or 36
        with rf as the production artifact had (``autoencoder_v4.ipynb``
        cell 47)."""
        parts = [self.factors, self.hf] + ([self.rf] if include_rf else [])
        return torch.cat(parts, dim=1)

    def train_test_split(self, test_size: float = 0.5):
        """Chronological split, no shuffle: the train block is
        ``floor(T * (1 - test_size))`` rows (168 of 337 at 0.5)."""
        n_train = int(self.n_months * (1.0 - test_size))
        return (self.factors[:n_train], self.factors[n_train:],
                self.hf[:n_train], self.hf[n_train:])


def load_panel(cleaned_dir: Union[str, Path] = DataConfig.cleaned_dir,
               device: DeviceLike = None) -> Panel:
    """The cleaned panel under ``cleaned_dir`` as float32 tensors on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    d = Path(cleaned_dir)
    hfd = read_csv(d / "hfd.csv")
    factor = read_csv(d / "factor_etf_data.csv")
    rf = read_csv(d / "rf.csv")

    def t(frame: Frame) -> torch.Tensor:
        return torch.from_numpy(frame.values.astype(np.float32)).to(dev)

    return Panel(factors=t(factor), hf=t(hfd), rf=t(rf), dates=hfd.dates,
                 factor_names=factor.columns, hf_names=hfd.columns,
                 factor_fullnames=dic_read(d / "factor_etf_name.pkl"),
                 hf_fullnames=dic_read(d / "hfd_fullname.pkl"))


@dataclasses.dataclass
class GanDataset:
    """MinMax-scaled window cube plus the params to undo the scaling."""

    windows: torch.Tensor           # (N, W, F) in [0, 1]
    scaler: mm.ScalerParams         # fit on the full joined panel
    panel_scaled: torch.Tensor      # (T, F)
    feature_names: List[str]


def build_gan_dataset(cfg: DataConfig,
                      generator: Union[torch.Generator, int, None] = None,
                      panel: Optional[Panel] = None,
                      starts: Optional[torch.Tensor] = None,
                      device: DeviceLike = None) -> GanDataset:
    """The reference dataset build (``GAN/MTSS_WGAN_GP.py:97-101``): join,
    MinMax-scale the whole panel, sample ``cfg.n_sample`` windows.

    ``generator`` is a ``torch.Generator`` or a seed; by default a CPU
    generator seeded with ``cfg.seed``, so a seed gives the same windows
    on every device.  ``starts`` overrides the draw (the test seam for
    JAX's starts).  Without ``panel`` it is loaded from
    ``cfg.cleaned_dir`` onto ``device``."""
    if panel is None:
        panel = load_panel(cfg.cleaned_dir, device=device)
    if not isinstance(generator, torch.Generator):
        seed = cfg.seed if generator is None else int(generator)
        generator = torch.Generator()
        generator.manual_seed(seed)
    joined = panel.joined(include_rf=cfg.include_rf)
    params, scaled = mm.fit_transform(joined)
    windows = sample_windows(scaled, cfg.n_sample, cfg.window, generator=generator,
                             starts=starts)
    names = panel.factor_names + panel.hf_names + (["rf"] if cfg.include_rf else [])
    return GanDataset(windows=windows, scaler=params, panel_scaled=scaled,
                      feature_names=names)
