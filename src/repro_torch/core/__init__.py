"""Core of the paper's method, in torch: deform.py (Eq. 1-3), tiles.py
(TDT), scheduler.py (Algorithm 1), simulator.py (DRAM traffic), fusion.py
(stage-fusion planner)."""
