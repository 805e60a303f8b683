"""The loops, one module a traffic mix's `kind`: `benchmark/loops/<kind>.py`
runs a cell of that kind from set-up through the window to the comparison
with the reference, through

    run(config, mix, seed, seconds, traced, device, set_up_done) -> Run

and gives `benchmark/control.py` the readings that the cell's limits are
set from, through

    readings(config, mix, seed, device, control) -> [row, ...]

`harness.run_cell` finds the loop by the mix's `kind`: a new kind of
traffic comes as a new file here, with no edit elsewhere."""
