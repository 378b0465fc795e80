"""SQL front end and planner (host copies of ``repro.sql``)."""
