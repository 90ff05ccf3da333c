"""Data-cleaning pipeline: re-derivation of ``cleaned_data/`` from the raw
vendor files (the port's copy of ``hfrep_tpu/core/cleaning.py``).

* ``rf.csv``: monthly risk-free rate, the month-sum of ``log1p(RF/100)``
  over the daily Fama-French RF column.
* ``hfd.csv``: the 13 hedge-fund indices of ``NAVROR_full.csv`` (percent
  strings, descending dates) as monthly excess log returns
  ``log1p(r) - rf`` over 1994-04-30..2022-04-30 (337 months).
* ``factor_etf_data.csv``: month-end level samples of the interleaved
  (date, value) column pairs of ``ETF_data.csv``, then
  ``log(level).diff() - rf``.

This module needs pandas.  Only the ``clean`` verb imports it, so
nothing on the training path loads pandas (the card machine has none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

#: The 22 factor tickers of cleaned_data/factor_etf_data.csv, in column order.
FACTOR_TICKERS = [
    "LUMSTRUU", "LT09STAT", "WGBI", "EMUSTRUU", "TWEXB", "SPGSCI_PM",
    "SPGSCI_Gra", "SPGSCI_O", "LCB1TRUU", "MSCI_EXUS", "MSCI_EM", "R1000",
    "R200", "FTSE_REIT", "VIX", "PUT", "PUTY", "CLL", "BFLY", "BXM", "BXY",
    "CLLZ",
]

#: Columns whose upstream daily source (ETF_data_full.csv) is a missing
#: blob; reproduced methodologically, not bitwise.
APPROXIMATE_TICKERS = frozenset(
    ["VIX", "PUT", "PUTY", "CLL", "BFLY", "BXM", "BXY", "CLLZ"])

#: Sample window of the cleaned panel: 337 month-ends.
SAMPLE_START, SAMPLE_END = "1994-04-30", "2022-04-30"


def _parse_mixed_dates(s: pd.Series) -> pd.Series:
    """Dates in ETF_data.csv come as ISO ``%Y-%m-%d`` and day-first
    ``%d-%m-%Y`` / ``%d/%m/%Y`` within the same column."""
    s = s.astype(str).str.replace("/", "-", regex=False)
    iso = pd.to_datetime(s, format="%Y-%m-%d", errors="coerce")
    return iso.fillna(pd.to_datetime(s, format="%d-%m-%Y", errors="coerce"))


def monthly_rf(ff_daily_csv: str) -> pd.Series:
    """Monthly rf as month-sums of ``log1p(RF_daily/100)``."""
    ff = pd.read_csv(ff_daily_csv)
    ff.columns = [c.strip() for c in ff.columns]
    datecol = ff.columns[0]
    ff[datecol] = pd.to_datetime(ff[datecol], format="%Y%m%d")
    ff = ff.set_index(datecol)
    rf = np.log1p(ff["RF"].astype(float) / 100.0).resample("ME").sum()
    rf.name = "RF"
    rf.index.name = "Date"
    return rf.loc[SAMPLE_START:SAMPLE_END]


def clean_hfd(navror_csv: str, rf: pd.Series) -> pd.DataFrame:
    """13 HF indices as monthly excess log returns (exact reproduction)."""
    raw = pd.read_csv(navror_csv, header=1, index_col=0)
    raw.index = pd.to_datetime(raw.index)
    raw = raw.sort_index()
    parsed = raw.apply(
        lambda c: c.astype(str).str.rstrip("%").astype(float) / 100.0)
    out = np.log1p(parsed).sub(rf, axis=0).dropna()
    out = out.loc[SAMPLE_START:SAMPLE_END]
    out.index.name = "Date"
    return out


def parse_etf_levels(etf_csv: str) -> Dict[str, pd.Series]:
    """Split the interleaved (date, value) column pairs into one level
    series per ticker (the value column's header is the ticker)."""
    raw = pd.read_csv(etf_csv, header=1)
    cols = raw.columns.tolist()
    series: Dict[str, pd.Series] = {}
    for i in range(0, len(cols) - 1, 2):
        datec, valc = cols[i], cols[i + 1]
        if valc.startswith("Unnamed"):
            continue
        block = raw[[datec, valc]].dropna()
        dates = _parse_mixed_dates(block[datec])
        vals = pd.to_numeric(block[valc], errors="coerce")
        ser = pd.Series(vals.values, index=dates.values, name=valc)
        ser = ser[~ser.index.isna()]
        ser = ser[~ser.index.duplicated(keep="last")].sort_index()
        series[valc] = ser
    return series


def clean_factor_etf(etf_csv: str, rf: pd.Series,
                     tickers: Optional[list] = None) -> pd.DataFrame:
    """22-factor panel: month-end level sample → excess log returns."""
    series = parse_etf_levels(etf_csv)
    tickers = tickers or FACTOR_TICKERS
    panel = pd.DataFrame({t: series[t] for t in tickers})
    month_end = panel.resample("ME").last()
    out = np.log(month_end).diff().sub(rf, axis=0)
    out = out.loc[SAMPLE_START:SAMPLE_END]
    out.index.name = "Date"
    return out


#: Full vendor names shipped in the two cleaned_data pickles.
HF_FULLNAMES = {
    "HEDG": "Hedge Fund Index ", "HEDG_CVARB": "Convertible Arbitrage",
    "HEDG_EMMKT": "Emerging Markets", "HEDG_EQNTR": "Equity Market Neutral",
    "HEDG_EVDRV": "Event Driven", "HEDG_DISTR": "Event Driven Distressed",
    "HEDG_MSEVD": "Event Driven Multi-Strategy",
    "HEDG_MRARB": "Event Driven Risk Arbitrage",
    "HEDG_FIARB": "Fixed Income Arbitrage", "HEDG_GLMAC": "Global Macro",
    "HEDG_LOSHO": "Long/Short Equity", "HEDG_MGFUT": "Managed Futures",
    "HEDG_MULTI": "Multi-Strategy",
}

FACTOR_FULLNAMES = {
    "LUMSTRUU": "Bloomberg US MBS",
    "LT09STAT": "Bloomberg U.S. Treasury: 7-10 Year Statistics",
    "WGBI": "FTSE World Government Bond",
    "EMUSTRUU": "Bloomberg EM USD Aggregate",
    "TWEXB": "Trade Weighted U.S. Dollar",
    "SPGSCI_PM": "S&P GSCI Precious Metals", "SPGSCI_Gra": "S&P GSCI Grains",
    "SPGSCI_O": "S&P GSCI Crude Oil", "LCB1TRUU": "Bloomberg Baa Corporate",
    "MSCI_EXUS": "MSCI World ex USA", "MSCI_EM": "MSCI Emerging Markets",
    "R1000": "Russell 1000", "R200": "Russell 2000",
    "FTSE_REIT": "FTSE Nareit US Real Estatees", "VIX": "VIX",
    "PUT": "S&P 500 PutWrite", "PUTY": "S&P 500 2% OTM PutWrite",
    "CLL": "S&P 500 95-110 Collar", "BFLY": "S&P 500 Iron Butterfly",
    "BXM": "S&P 500 BuyWrite", "BXY": "S&P 500 2% OTM BuyWrite",
    "CLLZ": "S&P 500 Zero-Cost Put Spread Collar",
}


@dataclasses.dataclass
class CleanResult:
    hfd: pd.DataFrame
    factor_etf: pd.DataFrame
    rf: pd.DataFrame


def run_cleaning(raw_dir: str, out_dir: Optional[str] = None) -> CleanResult:
    """L0 → L1: derive the cleaned monthly panel from raw vendor files.

    Writes the five cleaned_data artifacts to ``out_dir`` when given, in
    the same formats the reference ships (CSV with Date index; pickled
    name dicts).
    """
    rf = monthly_rf(os.path.join(raw_dir, "F-F_Research_Data_Factors_daily.CSV"))
    hfd = clean_hfd(os.path.join(raw_dir, "NAVROR_full.csv"), rf)
    factor = clean_factor_etf(os.path.join(raw_dir, "ETF_data.csv"), rf)
    rf_df = rf.to_frame()
    res = CleanResult(hfd=hfd, factor_etf=factor, rf=rf_df)
    if out_dir is not None:
        from hfrep_tpu_torch.core.data import dic_save

        os.makedirs(out_dir, exist_ok=True)
        hfd.to_csv(os.path.join(out_dir, "hfd.csv"))
        factor.to_csv(os.path.join(out_dir, "factor_etf_data.csv"))
        rf_df.to_csv(os.path.join(out_dir, "rf.csv"))
        # dic_save = write + read-back through the restricted unpickler
        # (helper.py:155-162 semantics + the plain-data invariant)
        dic_save(HF_FULLNAMES, os.path.join(out_dir, "hfd_fullname.pkl"))
        dic_save(FACTOR_FULLNAMES, os.path.join(out_dir, "factor_etf_name.pkl"))
    return res


def validate_against(res: CleanResult, ref_dir: str) -> Dict[str, object]:
    """Max-abs deviation of each derived artifact vs a reference
    ``cleaned_data/`` checkout; approximate (missing-source) factor
    columns are reported separately."""
    def load(name):
        df = pd.read_csv(os.path.join(ref_dir, name), index_col=0)
        df.index = pd.to_datetime(df.index)
        return df

    ref_hfd, ref_fac, ref_rf = load("hfd.csv"), load("factor_etf_data.csv"), load("rf.csv")
    exact_cols = [c for c in FACTOR_TICKERS if c not in APPROXIMATE_TICKERS]
    # Excess returns inherit the rf deviation, so the bitwise check is on
    # the underlying *total* log returns (excess + own rf).
    hfd_total = res.hfd.add(res.rf["RF"], axis=0)
    ref_hfd_total = ref_hfd.add(ref_rf["RF"], axis=0)
    fac_total = res.factor_etf[exact_cols].add(res.rf["RF"], axis=0)
    ref_fac_total = ref_fac[exact_cols].add(ref_rf["RF"], axis=0)
    approx_corr = {
        c: float(np.corrcoef(res.factor_etf[c].iloc[1:],
                             ref_fac[c].iloc[1:])[0, 1])
        for c in sorted(APPROXIMATE_TICKERS)}
    report = {
        "hfd_total": float(np.abs(hfd_total.values - ref_hfd_total.values).max()),
        "hfd_excess": float(np.abs(res.hfd.values - ref_hfd.values).max()),
        "rf": float(np.abs(res.rf.values - ref_rf.values).max()),
        "factor_total_exact_cols": float(
            np.abs(fac_total.values - ref_fac_total.values).max()),
        "factor_approx_corr_min": min(approx_corr.values()),
        "factor_approx_corr": approx_corr,
    }
    return report
