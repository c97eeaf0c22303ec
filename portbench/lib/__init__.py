"""The yardstick: window arithmetic, spans, trace reduction, peaks, work
counts, the import guard and the discovery of cells by name."""
