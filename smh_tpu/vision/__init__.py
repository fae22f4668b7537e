"""Vision subsystem: backends (numpy oracle + device), pipeline driver, LSD."""
