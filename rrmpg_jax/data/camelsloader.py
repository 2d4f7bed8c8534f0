"""CAMELS data loader.

Behavior-compatible with the reference ``CAMELSLoader``
(``rrmpg/data/camelsloader.py:14-129``): loads Daymet forcing and
model-output files per basin, joins PET and observed discharge, builds a
datetime index and trims to complete hydrological years (Oct 1 - Sep 30).

Beyond the reference (which bundles exactly one toy basin), the loader
accepts a user-supplied directory of CAMELS-format files for multi-basin
regional studies, discovers the available basin ids, and stacks several
basins into aligned arrays for the framework's regional (catchment-axis)
execution mode.

CAMELS: Addor, Newman, Mizukami & Clark (2017), doi:10.5065/D6G73C3Q.
"""

from pathlib import Path


class CAMELSLoader(object):
    """Interface for loading basins of the CAMELS dataset.

    Args:
        data_dir: (optional) directory containing CAMELS-format files
            (``<basin>_lump_cida_forcing_leap.txt`` plus
            ``<basin>_05_model_output.txt`` per basin).  Defaults to the
            bundled toy data (one basin, 01031500).
    """

    VALID_BASINS = ['01031500']

    def __init__(self, data_dir=None):
        self._custom_dir = Path(data_dir) if data_dir is not None else None
        if self._custom_dir is not None:
            if not self._custom_dir.is_dir():
                raise ValueError(
                    f"CAMELS directory {data_dir!r} does not exist.")
            suffix = '_lump_cida_forcing_leap.txt'
            basins = sorted(
                f.name[:-len(suffix)]
                for f in self._custom_dir.glob(f'*{suffix}')
                if (self._custom_dir /
                    f"{f.name[:-len(suffix)]}_05_model_output.txt").exists())
            if not basins:
                raise ValueError(
                    f"No CAMELS basin file pairs found in {data_dir!r} "
                    "(expected <basin>_lump_cida_forcing_leap.txt + "
                    "<basin>_05_model_output.txt).")
            self.VALID_BASINS = basins

    def _check_basin(self, basin_number):
        if basin_number not in self.VALID_BASINS:
            raise ValueError(
                f"No data for basin {basin_number!r}; available "
                f"basins: {self.VALID_BASINS}.")

    def _data_dir(self):
        if self._custom_dir is not None:
            return self._custom_dir
        return Path(__file__).parent / 'camels'

    def load_basin(self, basin_number):
        """Load one basin as a pandas DataFrame.

        Real CAMELS model-output files encode missing discharge as
        ``-999``; those rows come back as NaN in 'QObs(mm/d)' (observed
        runoff is non-negative, so any negative value is a sentinel).
        The framework's metrics and objectives treat NaN observations as
        masked gaps, so gapped basins calibrate correctly out of the box
        -- a divergence from the reference loader
        (``rrmpg/data/camelsloader.py:36-92``), which passes sentinels
        through to the objectives.

        Args:
            basin_number: string basin id (see :meth:`get_basin_numbers`).

        Returns:
            DataFrame with daily forcing columns, 'PET' and 'QObs(mm/d)',
            indexed by date and trimmed to complete hydrological years.

        Raises:
            ValueError: If the basin number is invalid.
        """
        import pandas as pd

        self._check_basin(basin_number)
        data_dir = self._data_dir()

        met_file = data_dir / f"{basin_number}_lump_cida_forcing_leap.txt"
        streamflow_file = data_dir / f"{basin_number}_05_model_output.txt"

        df = pd.read_csv(met_file, sep=r'\s+', header=3)
        df.index = pd.to_datetime(
            df[['Year', 'Mnth', 'Day']].set_axis(
                ['year', 'month', 'day'], axis=1))

        df2 = pd.read_csv(streamflow_file, sep=r'\s+', header=0)
        df2.index = pd.to_datetime(
            df2[['YR', 'MNTH', 'DY']].set_axis(
                ['year', 'month', 'day'], axis=1))

        df['PET'] = df2['PET']
        df['QObs(mm/d)'] = df2['OBS_RUN'].mask(df2['OBS_RUN'] < 0)

        df = df.drop(['Year', 'Mnth', 'Day', 'Hr'], axis=1)

        # Trim to complete hydrological years (Oct 1 - Sep 30).
        start_date = pd.to_datetime(f"{df.index[0].year}/10/01",
                                    format="%Y/%m/%d")
        end_date = pd.to_datetime(f"{df.index[-1].year}/09/30",
                                  format="%Y/%m/%d")
        return df[start_date:end_date]

    def get_basin_numbers(self):
        """Return the basin ids bundled with this package."""
        return self.VALID_BASINS

    def get_station_height(self, basin_number):
        """Return the elevation of the meteorological station of one basin.

        Raises:
            ValueError: If the basin number is invalid.
        """
        self._check_basin(basin_number)
        met_file = (self._data_dir() /
                    f"{basin_number}_lump_cida_forcing_leap.txt")
        with open(met_file, 'r') as fp:
            fp.readline()
            height = float(fp.readline().strip())
        return height

    def load_basins(self, basin_numbers=None, columns=None,
                    join='inner'):
        """Load several basins as aligned (C, T) arrays for regional mode.

        With ``join='inner'`` (default) only days present in every basin
        are kept.  With ``join='outer'`` basins of unequal record length
        are padded to the union of their date indices with NaN: the
        framework's metrics and regional objectives treat NaN
        *observations* as masked gaps, so ragged discharge records
        calibrate correctly -- but NaN *forcing* cannot be masked (the
        models need continuous forcing to step their stores), so an
        outer join is only safe when the forcing columns fully overlap
        and only the discharge records are ragged (the common CAMELS
        situation).  Padded forcing days raise below.

        Args:
            basin_numbers: basins to load (default: all available).
            columns: forcing/output columns to extract (default: every
                column shared by all basins).
            join: ``'inner'`` (intersection of dates) or ``'outer'``
                (union, NaN-padded observations).

        Returns:
            ``(index, arrays)``: the common datetime index and a dict
            mapping column name to a ``(num_basins, T)`` numpy array, in
            ``basin_numbers`` order.
        """
        import numpy as np

        if join not in ('inner', 'outer'):
            raise ValueError(
                f"join must be 'inner' or 'outer', got {join!r}.")
        if basin_numbers is None:
            basin_numbers = self.VALID_BASINS
        frames = [self.load_basin(b) for b in basin_numbers]

        index = frames[0].index
        for df in frames[1:]:
            index = (index.intersection(df.index) if join == 'inner'
                     else index.union(df.index))
        if len(index) == 0:
            raise ValueError(
                "The requested basins share no common dates; their "
                "periods of record do not overlap.")
        if columns is None:
            columns = [c for c in frames[0].columns
                       if all(c in df.columns for df in frames)]

        arrays = {
            c: np.stack([df.reindex(index)[c].to_numpy()
                         for df in frames])
            for c in columns
        }
        if join == 'outer':
            for c, arr in arrays.items():
                if c in ('QObs(mm/d)',):
                    continue  # NaN observations are masked downstream
                if not np.isfinite(arr).all():
                    raise ValueError(
                        f"join='outer' padded forcing column {c!r} with "
                        "NaN (the basins' forcing records do not fully "
                        "overlap); models cannot step over forcing "
                        "gaps. Restrict columns=, infill the forcing, "
                        "or use join='inner'.")
        return index, arrays
