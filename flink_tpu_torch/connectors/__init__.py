"""Sources and sinks."""
