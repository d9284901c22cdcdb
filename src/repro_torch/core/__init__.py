"""Core library of the port: compressors, granularity, UnitPlan, CommSchedule, wire codecs and Algorithm-1 aggregation."""
