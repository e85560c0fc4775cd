"""The serving side.  So far only the colormap core (``render``) is
ported, for the local render path; the gateway, caches and on-demand
compute come with the serving plane."""
