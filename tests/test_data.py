"""CAMELS loader tests (reference behavior parity)."""

import numpy as np
import pytest

from rrmpg_jax.data import CAMELSLoader


def test_basin_numbers():
    assert CAMELSLoader().get_basin_numbers() == ['01031500']


def test_invalid_basin_raises():
    with pytest.raises(ValueError):
        CAMELSLoader().load_basin('99999999')
    with pytest.raises(ValueError):
        CAMELSLoader().get_station_height('99999999')


def test_station_height():
    assert CAMELSLoader().get_station_height('01031500') == 318.0


def test_load_basin():
    df = CAMELSLoader().load_basin('01031500')
    for col in ['prcp(mm/day)', 'tmin(C)', 'tmax(C)', 'PET', 'QObs(mm/d)']:
        assert col in df.columns
    # trimmed to complete hydrological years: starts Oct 1, ends Sep 30
    assert (df.index[0].month, df.index[0].day) == (10, 1)
    assert (df.index[-1].month, df.index[-1].day) == (9, 30)
    # daily contiguous index
    assert (df.index[1:] - df.index[:-1]).days.max() == 1
    assert not df['QObs(mm/d)'].isna().any()
    assert np.all(df['prcp(mm/day)'].to_numpy() >= 0)


def test_camels_custom_directory(tmp_path):
    import shutil
    from pathlib import Path

    src = Path('rrmpg_jax/data/camels')
    # Build a fake user CAMELS dir with two basins (copies of the bundled
    # one under different ids).
    for basin in ('01031500', '99999999'):
        shutil.copy(src / '01031500_lump_cida_forcing_leap.txt',
                    tmp_path / f'{basin}_lump_cida_forcing_leap.txt')
        shutil.copy(src / '01031500_05_model_output.txt',
                    tmp_path / f'{basin}_05_model_output.txt')

    loader = CAMELSLoader(data_dir=str(tmp_path))
    assert loader.get_basin_numbers() == ['01031500', '99999999']
    df = loader.load_basin('99999999')
    assert 'QObs(mm/d)' in df.columns and len(df) > 1000
    assert loader.get_station_height('99999999') == 318.0

    index, arrays = loader.load_basins()
    assert arrays['QObs(mm/d)'].shape == (2, len(index))
    assert np.allclose(arrays['QObs(mm/d)'][0], arrays['QObs(mm/d)'][1])


def test_camels_custom_directory_rejects_empty(tmp_path):
    with pytest.raises(ValueError):
        CAMELSLoader(data_dir=str(tmp_path))
    with pytest.raises(ValueError):
        CAMELSLoader(data_dir=str(tmp_path / 'missing'))
