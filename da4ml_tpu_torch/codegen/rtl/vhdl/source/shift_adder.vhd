-- o = ((a' << SHA) +/- (b' << SHB)) >>> GSHIFT, truncated to WO bits.
-- VHDL twin of verilog/source/shift_adder.v (same parameterization).
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity shift_adder is
    generic (
        WA : integer := 8;
        SA : integer := 1;
        WB : integer := 8;
        SB : integer := 1;
        SHA : integer := 0;
        SHB : integer := 0;
        SUB_OP : integer := 0;
        GSHIFT : integer := 0;
        WO : integer := 8
    );
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        b : in std_logic_vector(WB - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of shift_adder is
    constant WI : integer := imax(imax(WA + SHA + 1, WB + SHB + 1), WO + GSHIFT) + 1;
    signal ea, eb, total, shifted : signed(WI - 1 downto 0);
begin
    ea <= ext(a, SA, WI);
    eb <= ext(b, SB, WI);
    total <= shift_left(ea, SHA) - shift_left(eb, SHB) when SUB_OP = 1
             else shift_left(ea, SHA) + shift_left(eb, SHB);
    shifted <= shift_right(total, GSHIFT);
    o <= std_logic_vector(shifted(WO - 1 downto 0));
end architecture;
