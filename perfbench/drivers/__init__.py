"""The cells' drivers, one module a driver, found by the name a cell file
gives under `driver` (`perfbench/drivers/<driver>.py`). Each has
`run(spec, seed, seconds, trace, device, t_start, fault=None,
tiny=False)` and `control(spec, seed, device)` (the control's readings,
for `core/calibrate.py`)."""
