"""Element ops (plain torch) and flash-decode attention."""
