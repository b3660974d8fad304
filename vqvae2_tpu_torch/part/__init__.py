"""Human-part parsing: the parsing head of the ReID net and its losses."""
