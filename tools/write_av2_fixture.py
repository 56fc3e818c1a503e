"""Write the committed AV2-format log of the synthetic demo scene.

    python tools/write_av2_fixture.py [--out tests/fixtures/av2_synthetic]

synthetic_av2(0) (mind_tpu_torch/synthetic.py), the scene of chip_smoke.py's
closed loop, under demo_1's sequence id, as an Argoverse 2 scenario folder:
<out>/<seq_id>/log_map_archive_<seq_id>.json (synthetic.write_synthetic_map)
and <out>/<seq_id>/scenario_<seq_id>.parquet, written by pandas'
DataFrame.to_parquet with its defaults (pyarrow: snappy, dictionary
encoding, OPTIONAL columns) in the columns and dtypes of av2-api's
serialize_argoverse_scenario_parquet. Beside it, <out>/demo_1_synthetic.json:
configs/demo_1.json with the closed loop's AV binding (planner on after 1 s,
8 m/s) and the camera on the synthetic road. Needs pandas and pyarrow, so it
runs off the card; the port reads the files with numpy alone.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEMO = "demo_1"
ENABLE_S, TARGET_VELOCITY = 1.0, 8.0
FRAME_NS = 100_000_000          # AV2 logs: 10 Hz


def av2_frame(scenario, n_frames: int):
    """The scenario as av2-api writes it: one row per track and timestep in
    the log's columns and dtypes, the scenario's fields repeated on every
    row."""
    import pandas as pd

    rows = [dict(observed=s.observed, track_id=t.track_id, object_type=t.object_type.value,
                 object_category=int(t.category), timestep=int(s.timestep),
                 position_x=s.position[0], position_y=s.position[1], heading=s.heading,
                 velocity_x=s.velocity[0], velocity_y=s.velocity[1])
            for t in scenario.tracks for s in t.object_states]
    df = pd.DataFrame(rows)
    df["scenario_id"] = scenario.scenario_id
    df["start_timestamp"] = 0
    df["end_timestamp"] = (n_frames - 1) * FRAME_NS
    df["num_timestamps"] = n_frames
    df["focal_track_id"] = scenario.focal_track_id
    df["city"] = scenario.city_name
    return df.astype({"observed": bool, "object_category": "int64", "timestep": "int64",
                      "start_timestamp": "int64", "end_timestamp": "int64",
                      "num_timestamps": "int64"})


def fixture_config(seq_id: str) -> dict:
    from mind_tpu_torch.synthetic import AV2_ORIGIN

    cfg = json.loads((ROOT / "configs" / f"{DEMO}.json").read_text())
    assert cfg["seq_id"] == seq_id
    cfg["render"] = True
    cfg["render_config"]["camera_position"].update(x=float(AV2_ORIGIN[0]),
                                                   y=float(AV2_ORIGIN[1]))
    cfg["cl_agents"][0].update(enable_timestep=ENABLE_S, target_velocity=TARGET_VELOCITY)
    return cfg


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from mind_tpu_torch.config import CONFIGS, SimConfig
    from mind_tpu_torch.synthetic import N_FRAMES, synthetic_av2, write_synthetic_map

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures" / "av2_synthetic"))
    opts = ap.parse_args(argv)
    out = Path(opts.out)
    seq_id = SimConfig.from_json(CONFIGS / f"{DEMO}.json").seq_id
    syn = synthetic_av2(0)
    write_synthetic_map(syn.map_json, out, seq_id)
    av2_frame(syn.scenario, N_FRAMES).to_parquet(out / seq_id / f"scenario_{seq_id}.parquet")
    (out / f"{DEMO}_synthetic.json").write_text(json.dumps(fixture_config(seq_id), indent=4)
                                                + "\n")
    print("wrote", *sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
