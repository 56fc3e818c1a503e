"""The port's Parquet reader (mind_tpu_torch/data/parquet.py) and its
load_scenario (data/av2.py) against pandas / pyarrow and mind_tpu's
load_scenario: the synthetic AV2 scene written in av2-api's columns under
every pyarrow writer setting the reader supports, equal field by field;
codecs it does not read raise a ValueError naming them; and the committed
AV2-format log (tests/fixtures/av2_synthetic, tools/write_av2_fixture.py)
reads through both packages to synthetic_av2(0)'s scenario exactly."""

import importlib.util
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from mind_tpu_torch.data import av2 as tav2
from mind_tpu_torch.data.parquet import read_parquet
from mind_tpu_torch.synthetic import N_FRAMES, synthetic_av2

pytest.importorskip("pandas")
pytest.importorskip("pyarrow")

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "av2_synthetic"
SEQ_ID = "24520ce8-038f-4e5e-a455-8c06877504ab"


def fixture_tool():
    spec = importlib.util.spec_from_file_location("write_av2_fixture",
                                                  ROOT / "tools" / "write_av2_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def frame():
    """synthetic_av2(1) in av2-api's columns, rows shuffled (tracks then
    appear out of order and their states out of timestep order)."""
    df = fixture_tool().av2_frame(synthetic_av2(1).scenario, N_FRAMES)
    return df.sample(frac=1.0, random_state=0).reset_index(drop=True)


def fields(scn):
    return (scn.scenario_id, scn.focal_track_id, scn.city_name,
            [(t.track_id, t.object_type.value, int(t.category),
              [(s.observed, s.timestep, s.position, s.heading, s.velocity)
               for s in t.object_states]) for t in scn.tracks])


def assert_scenarios_equal(got, want):
    """Every field of every track and state equal, with the same types."""
    assert fields(got) == fields(want)
    for t, u in zip(got.tracks, want.tracks):
        for s, r in zip(t.object_states, u.object_states):
            assert type(s.observed) is type(r.observed) is bool
            assert type(s.timestep) is type(r.timestep) is int
            assert all(type(v) is float for v in (*s.position, s.heading, *s.velocity))


WRITERS = [dict(compression=c, use_dictionary=d, data_page_version=p, version=v, **size)
           for c, d, p, v, size in itertools.product(
               ["snappy", "gzip", None], [True, False], ["1.0", "2.0"], ["1.0", "2.6"],
               [{}, dict(row_group_size=700, data_page_size=2048)])]


def writer_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", WRITERS, ids=writer_id)
def test_load_scenario_equals_mind_tpu(frame, tmp_path, kw):
    """Each pyarrow setting: the port's load_scenario equals mind_tpu's
    (pandas) on every field; the reader's columns equal pandas' values."""
    import pandas as pd

    from mind_tpu.data import av2 as jav2

    path = tmp_path / "scenario.parquet"
    frame.to_parquet(path, **kw)
    got = tav2.load_scenario(path)
    assert_scenarios_equal(got, jav2.load_scenario(path))
    assert len(got.tracks) == 40
    cols = read_parquet(path)
    want = pd.read_parquet(path)
    assert list(cols) == list(want.columns)
    for name in want.columns:
        assert (cols[name] == want[name].to_numpy()).all(), name
    if "row_group_size" in kw:
        import pyarrow.parquet as pq

        meta = pq.ParquetFile(path).metadata
        assert meta.num_row_groups > 1


@pytest.mark.parametrize("codec", ["zstd", "brotli", "lz4"])
def test_unsupported_codec_raises_naming_it(frame, tmp_path, codec):
    path = tmp_path / "scenario.parquet"
    frame.to_parquet(path, compression=codec)
    with pytest.raises(ValueError, match=codec.upper()):
        tav2.load_scenario(path)


def test_unsupported_encoding_type_and_nulls_raise(frame, tmp_path):
    """A delta encoding, an INT96 column and a null each raise a ValueError
    that names them; nothing is skipped silently."""
    import pandas as pd
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = tmp_path / "t.parquet"
    pq.write_table(pa.table({"x": pa.array(np.arange(50, dtype=np.int64))}), path,
                   use_dictionary=False, column_encoding={"x": "DELTA_BINARY_PACKED"})
    with pytest.raises(ValueError, match="DELTA_BINARY_PACKED"):
        read_parquet(path)
    pq.write_table(pa.table({"t": pa.array(pd.date_range("2020", periods=3))}), path,
                   use_deprecated_int96_timestamps=True)
    with pytest.raises(ValueError, match="INT96"):
        read_parquet(path)
    pd.DataFrame({"v": [1.0, None, 3.0]}).to_parquet(path)
    with pytest.raises(ValueError, match="null"):
        read_parquet(path)
    path.write_bytes(b"not a parquet file")
    with pytest.raises(ValueError, match="not a Parquet file"):
        read_parquet(path)


def test_committed_fixture_reads_to_the_synthetic_scene():
    """tests/fixtures/av2_synthetic holds synthetic_av2(0) under demo_1's
    sequence id: both packages read its parquet to that scenario exactly;
    its map is synthetic_av2(0)'s; its config is demo_1's with the closed
    loop's AV binding and the camera on the synthetic road."""
    from mind_tpu.data import av2 as jav2
    from test_torch_data import to_jax_scenario

    syn = synthetic_av2(0)
    path = FIXTURE / SEQ_ID / f"scenario_{SEQ_ID}.parquet"
    assert path.stat().st_size < 512 * 1024
    got = tav2.load_scenario(path)
    assert_scenarios_equal(got, syn.scenario)
    assert fields(jav2.load_scenario(path)) == fields(to_jax_scenario(syn.scenario))
    cols = read_parquet(path)
    assert list(cols) == ["observed", "track_id", "object_type", "object_category", "timestep",
                          "position_x", "position_y", "heading", "velocity_x", "velocity_y",
                          "scenario_id", "start_timestamp", "end_timestamp", "num_timestamps",
                          "focal_track_id", "city"]
    assert (cols["num_timestamps"] == N_FRAMES).all()
    assert json.loads((FIXTURE / SEQ_ID / f"log_map_archive_{SEQ_ID}.json").read_text()) == \
        json.loads(json.dumps(syn.map_json))
    tool = fixture_tool()
    assert json.loads((FIXTURE / "demo_1_synthetic.json").read_text()) == \
        tool.fixture_config(SEQ_ID)


def test_snappy_decoder_on_overlapping_copies():
    """Copies whose offset is shorter than their length (runs), literals
    with a length byte, and each copy width, against pyarrow's encoder."""
    import pyarrow as pa

    from mind_tpu_torch.data.parquet import snappy_decompress

    rng = np.random.default_rng(2)
    blobs = [b"a" * 1000, b"ab" * 700 + bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
             bytes(rng.integers(0, 4, 70000, dtype=np.uint8)), b""]
    for blob in blobs:
        packed = pa.compress(blob, codec="snappy", asbytes=True)
        assert snappy_decompress(packed) == blob
